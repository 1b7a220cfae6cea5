"""Arithmetic the per-layer metric readers share: a kernel's share of its
roofline over the calls a traced stretch holds, each call's work from the
benchmark's own counts (``counts/<kernel>.py``) at the shapes the host
stamps tie it to.  A kernel's device names (its ``__global__`` functions)
are ``DEVICE_NAMES`` in its counts file."""
from __future__ import annotations

from collections import Counter

from . import peaks
from .trace import attribute


def in_window(trace, ops):
    return [o for o in ops if trace.h0 <= o[1] < trace.h1]


def kernel_ops(run, kernel: str):
    """The traced stretch's calls of ``kernel``, by the device names its
    counts file gives."""
    out = []
    for needle in run.module("counts", kernel).DEVICE_NAMES:
        out += run.trace.kernels(needle)
    return in_window(run.trace, out)


def roofline(ops_with_work, dtype: str) -> "float | None":
    """100 x the least time of the calls (the larger of operations over the
    dtype's peak and bytes over the HBM rate) over their device time.
    ``ops_with_work``: ((op, ...), (flops, bytes) or None for an op whose
    work another op of the same call carries)."""
    least = spent = 0.0
    for op, work in ops_with_work:
        spent += (op[2] - op[1]) / 1e9
        if work is not None:
            least += peaks.least_seconds(work[0], work[1], dtype)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def decode_stream(run) -> "int | None":
    """The stream the decode lane runs on: the one that runs paged_attention."""
    streams = Counter(o[3] for o in kernel_ops(run, "paged_attention"))
    return streams.most_common(1)[0][0] if streams else None


def prefill_calls(run, kernel: str):
    """Each kernel op of the traced stretch with the prefill batch
    ``(start_ns, end_ns, rows, tokens)`` whose call launched it."""
    stamps = [(p[0], p) for p in sorted(run.prefills)]
    return attribute(kernel_ops(run, kernel), stamps)
