"""Checkpoint lifecycle (the reference's ``checkpoint/manager.py``):
rotation, latest-discovery, async saves and the ``.meta.json`` sidecar.

Checkpoints are ``step_<8 digits>.npz`` files in the reference's npz
layout (``checkpoint/store.py``) beside a sidecar holding the step, the
per-group spectral ranks and, when the manager has one, the serialized
RunSpec, so either package resumes from the other's files. A save takes
its host snapshot on the caller's thread (training steps update the
state in place, so the writer must never read the live tensors), then
writes the npz, the sidecar and the rotation on a background thread
unless the caller blocks, one save in flight at a time. A checkpoint is visible only after
its atomic rename, so a crash mid-write never corrupts the restore path.
Cross-rank restore (``target_rank``) is not ported.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.store import host_tree, load_pytree, save_pytree
from repro_torch.core.spectral import is_spectral

_CKPT_RE = re.compile(r"^step_(\d+)\.npz$")


def rank_metadata(params: Any, path: str = "") -> Dict[str, int]:
    """``{group_path: retained rank}`` for every spectral group, paths
    in the npz key space."""
    if is_spectral(params):
        return {path: int(params["s"].shape[-1])}
    out: Dict[str, int] = {}
    if isinstance(params, dict):
        for k in sorted(params):
            out.update(rank_metadata(params[k], f"{path}/{k}" if path else k))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 run_spec: Optional[Dict[str, Any]] = None):
        self.directory = directory
        self.keep = keep
        self.run_spec = run_spec
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def _meta_path(self, step: int) -> str:
        return self._path(step) + ".meta.json"

    def list_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Any, block: bool = False) -> None:
        """Checkpoint ``state`` at ``step``: its host snapshot now (tensors
        copied off the device, or off their live CPU storage), then the
        npz, its sidecar and the rotation to the ``keep`` newest, on the
        writer thread unless ``block``. A save in flight is waited for
        first."""
        self.wait()
        snapshot = host_tree(state)
        params = snapshot.get("params", snapshot) if isinstance(snapshot, dict) else snapshot
        meta = {"step": step, "ranks": rank_metadata(params)}
        if self.run_spec is not None:
            meta["run_spec"] = self.run_spec

        def write():
            save_pytree(snapshot, self._path(step))
            tmp = self._meta_path(step) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            os.replace(tmp, self._meta_path(step))
            self._rotate()

        if not block:
            def run():
                try:
                    write()
                except Exception as e:  # noqa: BLE001 — re-raised by wait()
                    self._error = e

            self._thread = threading.Thread(target=run, name=f"ckpt-{step}", daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the save in flight, if any; a writer's error is raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def run_spec_for(self, step: int) -> Optional[Dict[str, Any]]:
        """The serialized RunSpec embedded at ``step``'s save, or None."""
        try:
            with open(self._meta_path(step)) as f:
                return dict(json.load(f)["run_spec"])
        except (FileNotFoundError, KeyError, json.JSONDecodeError, TypeError):
            return None

    def latest_run_spec(self) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
        """(step, serialized RunSpec) of the newest checkpoint, or
        (None, None) for an empty directory."""
        self.wait()
        steps = self.list_steps()
        if not steps:
            return None, None
        return steps[-1], self.run_spec_for(steps[-1])

    def _rotate(self) -> None:
        for s in self.list_steps()[: -self.keep] if self.keep else []:
            for path in (self._path(s), self._meta_path(s)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def restore_latest(self) -> Tuple[Optional[int], Any]:
        """(step, state as numpy arrays) of the newest checkpoint, or
        (None, None)."""
        self.wait()
        steps = self.list_steps()
        if not steps:
            return None, None
        return steps[-1], self.restore(steps[-1])

    def restore(self, step: int) -> Any:
        """The checkpoint at ``step`` as a tree of numpy arrays."""
        return load_pytree(self._path(step))
