"""Serving on PyTorch: per-step decode/prefill builders, scheduler-routed
fan-out, the continuous-batching ``RequestEngine`` (DESIGN.md §12), and the
paged-KV prefill/decode-disaggregated ``PagedServeEngine`` over a fleet of
page pools (one decode lane a device)."""
from repro_torch.serving.engine import EngineClosed, LanePolicy, QueueFull, RequestEngine
from repro_torch.serving.paged import (
    OutOfPages,
    PagedKVCache,
    PagedServeEngine,
    PagePool,
    PageSpec,
    SamplingParams,
    SeqPages,
    sample_token,
    warm_rows,
)
from repro_torch.serving.serve_step import (
    cache_to_rows,
    make_prefill,
    make_serve_engine,
    make_serve_fanout,
    make_serve_step,
    rows_to_cache,
    route_batches,
)

__all__ = [
    "RequestEngine",
    "QueueFull",
    "EngineClosed",
    "LanePolicy",
    "PageSpec",
    "PagePool",
    "PagedKVCache",
    "PagedServeEngine",
    "SamplingParams",
    "SeqPages",
    "OutOfPages",
    "sample_token",
    "warm_rows",
    "cache_to_rows",
    "make_prefill",
    "make_serve_engine",
    "make_serve_fanout",
    "make_serve_step",
    "rows_to_cache",
    "route_batches",
]
