"""Serving on PyTorch: prefill and greedy decode steps, and the paged-KV
prefill/decode-disaggregated ``PagedServeEngine`` over a fleet of page
pools (one decode lane a device).  ``RequestEngine`` and the
scheduler-routed fan-out of ``serve_step`` come with ROADMAP.md Queue 1
item 8."""
from repro_torch.serving.engine import EngineClosed, LanePolicy, QueueFull
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
from repro_torch.serving.serve_step import make_prefill, make_serve_step

__all__ = [
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
    "make_prefill",
    "make_serve_step",
]
