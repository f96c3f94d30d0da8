"""Declarative run specs (the reference's ``api/specs.py``): ``RunSpec``
over ``ModelSpec``, ``TrainSpec``, ``PrecisionSpec``,
``RankScheduleSpec``, ``ShardingSpec``, ``ServeSpec`` (with its
``StreamingSpec``) and ``CheckpointSpec``.

Specs are frozen values with a bit-exact JSON round trip; unknown keys
are rejected, ``replace`` validates its field names. The JSON is the
reference's, in both directions: the same spec gives the same text, and
a checkpoint sidecar written by either package describes the run to the
other. What the port does not run is refused where a spec would ask for
it: a rank schedule (ROADMAP queue 1 item 9) and any mesh axis above one
(items 8 and 10) raise ``NotImplementedError`` when the spec is built;
``ServeSpec``'s speculative and disaggregated fields round-trip, and
``api/server.py:Server`` refuses them (items 6 and 8).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["ModelSpec", "TrainSpec", "PrecisionSpec", "RankScheduleSpec", "ShardingSpec",
           "StreamingSpec", "ServeSpec", "CheckpointSpec", "RunSpec"]

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
class RankScheduleSpec(_Spec):
    """Adaptive-rank policy as its CLI grammar string, or None for
    fixed-rank training. Only None is ported: ``rank/`` is ROADMAP queue 1
    item 9."""
    schedule: Optional[str] = None

    def __post_init__(self):
        if self.schedule is not None:
            raise NotImplementedError(
                f"rank schedule {self.schedule!r}: adaptive rank is not ported "
                "(ROADMAP queue 1 item 9)")


@_spec
class ShardingSpec(_Spec):
    """Mesh geometry: ``data``/``model`` (training) and ``decode_mesh``
    (tensor-parallel serving). The port runs on one device: None or 1 on
    every axis; anything larger raises (training across devices is ROADMAP
    queue 1 item 10, tensor-parallel serving item 8)."""
    data: Optional[int] = None
    model: Optional[int] = None
    decode_mesh: Optional[int] = None

    def __post_init__(self):
        if self.decode_mesh is not None and self.decode_mesh < 1:
            raise ValueError(f"decode_mesh {self.decode_mesh} must be >= 1")
        for axis in ("data", "model"):
            if getattr(self, axis) not in (None, 1):
                raise NotImplementedError(
                    f"sharding {axis}={getattr(self, axis)}: training across devices is not "
                    "ported (ROADMAP queue 1 item 10)")
        if self.decode_mesh not in (None, 1):
            raise NotImplementedError(
                f"sharding decode_mesh={self.decode_mesh}: tensor-parallel serving is not "
                "ported (ROADMAP queue 1 item 8)")

    def serve_mesh(self):
        """The tensor-parallel serve mesh: None, single-device serving."""
        return None


@_spec
class StreamingSpec(_Spec):
    """Long-context streaming KV policy (``serving/streaming.py``):
    ``window_pages=None`` turns streaming off; otherwise ``sink_pages``
    pinned pages plus a sliding window, and ``cold_kv="int8"`` demotes the
    resident pages older than the window to int8 shadow pools."""
    sink_pages: int = 1
    window_pages: Optional[int] = None
    cold_kv: str = "none"

    def __post_init__(self):
        if self.sink_pages < 1:
            raise ValueError(f"sink_pages {self.sink_pages} must be >= 1")
        if self.window_pages is not None and self.window_pages < 1:
            raise ValueError(f"window_pages {self.window_pages} must be >= 1")
        if self.cold_kv not in ("none", "int8"):
            raise ValueError(f"cold_kv {self.cold_kv!r}; options none|int8")
        if self.cold_kv != "none" and self.window_pages is None:
            raise ValueError("cold_kv needs streaming on (set window_pages)")

    @property
    def enabled(self) -> bool:
        return self.window_pages is not None

    def config(self):
        """The runtime StreamingConfig, or None when disabled."""
        if not self.enabled:
            return None
        from repro_torch.serving.streaming import StreamingConfig

        return StreamingConfig(sink_pages=self.sink_pages, window_pages=self.window_pages,
                               cold_kv=self.cold_kv)


def parse_ladder(spec: Any) -> List[int]:
    """The speculative rank ladder's grammar (``"32"`` or ``"32,128"``,
    drafter first, positive, non-decreasing): the reference's
    ``src/repro/serving/speculative.py:71``, kept so that a spec naming a
    ladder validates as it does there."""
    if isinstance(spec, int):
        ranks = [spec]
    elif isinstance(spec, str):
        try:
            ranks = [int(r) for r in spec.split(",") if r.strip()]
        except ValueError:
            raise ValueError(f"speculative rank ladder {spec!r}: want comma-separated ints, "
                             "lowest (drafter) first")
    else:
        ranks = [int(r) for r in spec]
    if not ranks:
        raise ValueError("speculative rank ladder must name at least one rank")
    if any(r < 1 for r in ranks):
        raise ValueError(f"speculative rank ladder {ranks}: ranks must be >= 1")
    if ranks != sorted(ranks):
        raise ValueError(f"speculative rank ladder {ranks} must be non-decreasing "
                         "(drafter first, target implicit)")
    return ranks


@_spec
class ServeSpec(_Spec):
    """The serving side. ``mode="paged"`` is the continuous-batching
    engine (page geometry, slots, prefill budget, prefix cache, chunked
    prefill, deadlines, int8 weights, streaming); ``mode="static"`` is the
    dense-cache path, which reads ``batch``/``prompt_len``/``gen``/
    ``quantize``. ``gen`` is ``Server.submit``'s default
    ``max_new_tokens``; ``scheduler`` is ``"fifo"`` or ``"slo"``
    (``serving/scheduler.py:SLOScheduler``; ``shed=False`` keeps its order
    and sheds nothing); ``tenant``/``priority``/``default_deadline`` are
    ``submit``'s per-request defaults (``default_deadline`` falls back to
    ``request_timeout``). ``rank`` resizes spectral groups at load, and
    only the checkpoint's own rank is ported; ``speculative_rank``,
    ``draft_tokens``, ``disaggregate`` and ``kv_transfer`` round-trip and
    validate as in the reference, and the ``Server`` refuses them."""
    mode: str = "paged"
    slots: int = 4
    page_size: int = 16
    num_pages: int = 64
    pages_per_seq: int = 8
    prefill_budget: Optional[int] = 64
    prefix_cache: bool = False
    chunked_prefill: bool = False
    request_timeout: Optional[int] = None
    quantize: Optional[str] = None
    rank: Optional[int] = None
    batch: int = 4
    prompt_len: int = 16
    gen: int = 32
    scheduler: str = "fifo"
    shed: bool = True
    tenant: str = "default"
    priority: int = 0
    default_deadline: Optional[int] = None
    speculative_rank: Optional[str] = None
    draft_tokens: int = 4
    disaggregate: bool = False
    kv_transfer: str = "raw"
    streaming: StreamingSpec = StreamingSpec()

    def __post_init__(self):
        if self.mode not in ("paged", "static"):
            raise ValueError(f"serve mode {self.mode!r}; options paged|static")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize {self.quantize!r}; options int8")
        if self.scheduler not in ("fifo", "slo"):
            raise ValueError(f"serve scheduler {self.scheduler!r}; options fifo|slo")
        if self.priority < 0:
            raise ValueError(f"priority {self.priority} must be >= 0 "
                             "(0 is the most urgent class)")
        if not self.tenant:
            raise ValueError("tenant must be a non-empty string")
        if self.draft_tokens < 1:
            raise ValueError(f"draft_tokens {self.draft_tokens} must be >= 1")
        if self.speculative_rank is not None:
            if self.mode != "paged":
                raise ValueError("speculative decoding needs mode='paged'")
            if self.prefix_cache:
                raise ValueError("speculative_rank and prefix_cache are mutually exclusive")
            self.speculative_ladder()
        if self.kv_transfer not in ("raw", "int8"):
            raise ValueError(f"kv_transfer {self.kv_transfer!r}; options raw|int8")
        if self.disaggregate:
            if self.mode != "paged":
                raise ValueError("disaggregated prefill needs mode='paged'")
            if self.prefix_cache:
                raise ValueError("disaggregate and prefix_cache are mutually exclusive")
            if self.speculative_rank is not None:
                raise ValueError("disaggregate and speculative_rank are mutually exclusive")
        if self.streaming.enabled:
            if self.mode != "paged":
                raise ValueError("streaming KV needs mode='paged'")
            if self.speculative_rank is not None:
                raise ValueError("streaming and speculative_rank are mutually exclusive")
            if self.disaggregate:
                raise ValueError("streaming and disaggregate are mutually exclusive")
            cap = self.streaming.sink_pages + self.streaming.window_pages + 1
            if cap > self.pages_per_seq:
                raise ValueError(
                    f"streaming resident cap {cap} pages (sink + window + growth) exceeds "
                    f"pages_per_seq={self.pages_per_seq}")

    def speculative_ladder(self) -> list:
        """The parsed rank ladder (drafter first), or [] without speculation."""
        return [] if self.speculative_rank is None else parse_ladder(self.speculative_rank)

    @property
    def effective_deadline(self) -> Optional[int]:
        """``submit``'s deadline default: ``default_deadline``, else
        ``request_timeout``."""
        return (self.default_deadline if self.default_deadline is not None
                else self.request_timeout)

    def paged_config(self):
        from repro_torch.serving.paged_cache import PagedCacheConfig

        return PagedCacheConfig(page_size=self.page_size, num_pages=self.num_pages,
                                max_slots=self.slots, max_pages_per_seq=self.pages_per_seq)


@_spec
class CheckpointSpec(_Spec):
    """Where and how often the run checkpoints; ``directory=None`` means
    none (``Trainer.fit`` needs one, ``Trainer.step`` does not)."""
    directory: Optional[str] = None
    every: int = 50
    keep: int = 3


@_spec
class RunSpec(_Spec):
    """One run, trained and served. Derive variants with :meth:`replace`
    (sub-spec instances, dicts merged into a sub-spec, or dotted leaf
    paths such as ``{"train.steps": 6}`` or ``{"serve.quantize": "int8"}``).
    A sidecar without a ``serve`` (or ``rank``, ``sharding``) entry reads
    back with that sub-spec's defaults."""
    model: ModelSpec = ModelSpec()
    train: TrainSpec = TrainSpec()
    precision: PrecisionSpec = PrecisionSpec()
    rank: RankScheduleSpec = RankScheduleSpec()
    sharding: ShardingSpec = ShardingSpec()
    serve: ServeSpec = ServeSpec()
    checkpoint: CheckpointSpec = CheckpointSpec()

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
