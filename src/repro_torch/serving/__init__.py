"""Serving runtime: paged KV cache + continuous batching.

``ServingEngine`` is imported lazily (the engine imports the models,
which import the paged-cache ops from this package)."""
from repro_torch.serving.paged_cache import (
    PagedCacheConfig,
    PagePool,
    copy_page,
    paged_append,
    paged_gather,
    paged_write_slice,
)
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    PrefixCache,
    Request,
    SLOScheduler,
)

__all__ = [
    "PagedCacheConfig", "PagePool", "PrefixCache", "copy_page", "paged_append",
    "paged_gather", "paged_write_slice", "ContinuousBatchingScheduler", "Request",
    "SLOScheduler",
    "ServingEngine",
]


def __getattr__(name):
    if name == "ServingEngine":
        from repro_torch.serving.engine import ServingEngine
        return ServingEngine
    raise AttributeError(name)
