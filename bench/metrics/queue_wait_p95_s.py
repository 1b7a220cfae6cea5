"""A request's wait in the serving engine's queue, 95th percentile: its
``serve.queue`` span (``submit`` to the prefill lane taking it into a
batch) over the spans the engine kept in the window (it clears them as
the window opens and is read as it closes).  A program that keeps no spans
reads nothing."""
from benchlib.result import percentile


def read(run):
    e = getattr(run, "engine", None)
    waits = [(s[2] - s[1]) / 1e9 for s in (e or {}).get("spans", ()) if s[0] == "serve.queue"]
    return percentile(waits, 95) if waits else None
