"""Declarative run specs: the subset of the reference's ``api/specs.py``
that the Trainer needs — ``RunSpec`` over ``ModelSpec``, ``TrainSpec``,
``PrecisionSpec`` and ``CheckpointSpec``.

Specs are frozen values with a bit-exact JSON round trip; unknown keys
are rejected, ``replace`` validates its field names. The JSON is the
reference's: a checkpoint sidecar written by either package describes
the run to the other. A reference spec's ``rank``, ``sharding`` and
``serve`` entries are read as far as training on one device goes: no
rank schedule and no mesh (anything else raises NotImplementedError);
``serve`` does not concern training and is dropped.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

__all__ = ["ModelSpec", "TrainSpec", "PrecisionSpec", "CheckpointSpec", "RunSpec"]

PRECISION_MODES = ("legacy", "fp32", "bf16", "mixed")


class _Spec:
    """Base of the spec dataclasses: dict/JSON round trip with
    unknown-key rejection, and field-validated ``replace``."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "_Spec":
        if not isinstance(data, dict):
            raise TypeError(f"{cls.__name__}.from_dict wants a dict, "
                            f"got {type(data).__name__}")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - set(fields))
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown key(s) {unknown} "
                             f"(known: {sorted(fields)})")
        kw = {}
        for name, value in data.items():
            sub = _subspec_type(fields[name])
            kw[name] = sub.from_dict(value) if sub is not None else value
        return cls(**kw)

    def replace(self, **overrides) -> "_Spec":
        fields = {f.name for f in dataclasses.fields(self)}
        unknown = sorted(set(overrides) - fields)
        if unknown:
            raise ValueError(f"{type(self).__name__}.replace: unknown "
                             f"field(s) {unknown} (known: {sorted(fields)})")
        return dataclasses.replace(self, **overrides)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "_Spec":
        return cls.from_dict(json.loads(text))


def _subspec_type(field: dataclasses.Field):
    return type(field.default) if isinstance(field.default, _Spec) else None


def _spec(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_spec
class ModelSpec(_Spec):
    """An arch id of the config registry plus the SCT overrides a sweep
    needs: ``rank`` overrides ``cfg.sct.rank``; ``spectral_mlp=False``
    is the dense baseline."""
    arch: str = "smollm2-1.7b"
    reduced: bool = False
    rank: Optional[int] = None
    spectral_mlp: Optional[bool] = None

    def config(self):
        from repro_torch.config import get_config

        cfg = get_config(self.arch, reduced=self.reduced)
        sct_kw = {}
        if self.rank is not None:
            sct_kw["rank"] = int(self.rank)
        if self.spectral_mlp is not None:
            sct_kw["spectral_mlp"] = bool(self.spectral_mlp)
        return cfg.replace_sct(**sct_kw) if sct_kw else cfg


@_spec
class TrainSpec(_Spec):
    """Step budget, batch geometry, LR schedule inputs, microbatching and
    the data/init seed. ``warmup=None`` is ``min(100, steps // 10 + 1)``."""
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 1e-3
    warmup: Optional[int] = None
    microbatches: int = 1
    seed: int = 0
    telemetry: bool = False

    @property
    def warmup_steps(self) -> int:
        return self.warmup if self.warmup is not None else min(100, self.steps // 10 + 1)


@_spec
class PrecisionSpec(_Spec):
    """The precision mode (``core/precision.py``): ``legacy`` (compute in
    ``ModelConfig.dtype`` over fp32 masters), ``fp32``, ``bf16`` (bf16
    factors and compute) or ``mixed`` (fp32 masters, bf16 compute,
    dynamic loss scaling with overflow skip)."""
    mode: str = "legacy"

    def __post_init__(self):
        if self.mode not in PRECISION_MODES:
            raise ValueError(f"precision mode {self.mode!r}; options {list(PRECISION_MODES)}")

    def policy(self):
        from repro_torch.core.precision import precision_policy

        return precision_policy(self.mode)


@_spec
class CheckpointSpec(_Spec):
    """Where and how often the run checkpoints; ``directory=None`` means
    none (``Trainer.fit`` needs one, ``Trainer.step`` does not)."""
    directory: Optional[str] = None
    every: int = 50
    keep: int = 3


def _single_device_only(data: Dict[str, Any]) -> None:
    """Reject a reference spec that asks for what training here lacks."""
    rank = data.get("rank") or {}
    if rank.get("schedule") is not None:
        raise NotImplementedError(
            f"rank schedule {rank['schedule']!r}: adaptive rank is not ported")
    sharding = data.get("sharding") or {}
    for axis in ("data", "model"):
        if sharding.get(axis) not in (None, 1):
            raise NotImplementedError(
                f"sharding {axis}={sharding[axis]}: training across devices is not ported")


@_spec
class RunSpec(_Spec):
    """One training run. Derive variants with :meth:`replace` (sub-spec
    instances, dicts merged into a sub-spec, or dotted leaf paths such
    as ``{"train.steps": 6}``)."""
    model: ModelSpec = ModelSpec()
    train: TrainSpec = TrainSpec()
    precision: PrecisionSpec = PrecisionSpec()
    checkpoint: CheckpointSpec = CheckpointSpec()

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "RunSpec":
        if isinstance(data, dict):
            _single_device_only(data)
            data = {k: v for k, v in data.items() if k not in ("rank", "sharding", "serve")}
        return super().from_dict(data)

    def replace(self, **overrides) -> "RunSpec":
        fields = {f.name: f for f in dataclasses.fields(self)}
        merged: Dict[str, Dict[str, Any]] = {}
        flat: Dict[str, Any] = {}
        for key, value in overrides.items():
            name, dot, leaf = key.partition(".")
            if name not in fields:
                raise ValueError(f"RunSpec.replace: unknown field {name!r} "
                                 f"(known: {sorted(fields)})")
            if dot:
                merged.setdefault(name, {})[leaf] = value
            elif isinstance(value, dict):
                merged.setdefault(name, {}).update(value)
            elif isinstance(value, type(fields[name].default)):
                flat[name] = value
            else:
                raise TypeError(f"RunSpec.replace: {name} wants "
                                f"{type(fields[name].default).__name__}, a dict or a "
                                f"dotted '{name}.<field>' override, got {type(value).__name__}")
        for name, sub in merged.items():
            flat[name] = flat.get(name, getattr(self, name)).replace(**sub)
        return dataclasses.replace(self, **flat)
