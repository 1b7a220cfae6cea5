"""The engine policy and refusal types that ``serving/paged.py`` uses: the
port's own copy of ``QueueFull``, ``EngineClosed`` and ``LanePolicy`` from
``src/repro/serving/engine.py``.  ``RequestEngine`` (continuous batching)
comes with its own slice (ROADMAP.md Queue 1 item 8)."""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EngineClosed", "LanePolicy", "QueueFull"]


class QueueFull(RuntimeError):
    """Backpressure: the admission queue is at capacity — shed or retry."""


class EngineClosed(RuntimeError):
    """The engine no longer accepts (or will never run) this request."""


@dataclass(frozen=True)
class LanePolicy:
    """Per-kind batching policy (prefill/decode disaggregation).

    *Prefill* is throughput-bound — batch as many prompt tokens as fit a
    budget, tolerate a longer assembly window — while *decode* is
    latency-bound — dispatch at a tight deadline, rows are cheap.  ``None``
    fields inherit the engine-wide default.  ``token_budget`` bounds a
    batch by ``rows × tokens_per_row``, so long prompts batch fewer rows
    and short ones more."""

    max_batch: "int | None" = None
    max_delay_s: "float | None" = None
    token_budget: "int | None" = None
