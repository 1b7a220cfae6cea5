"""Device idle milliseconds a prefill batch of the serving engine holds:
the traced stretch's time with no operation on any stream (the complement
of ``Trace.busy_intervals``) that falls inside the engine's
``serve.prefill`` spans, over the ``serve.prefill`` spans that start in
the stretch.  The spans and the device operations are on one clock,
``time.time_ns()`` (``benchlib.trace``).  A program that keeps no spans
reads nothing."""


def _idle(t):
    """The traced stretch's intervals with no operation on the device."""
    gaps, at = [], t.h0
    for s, e in t.busy_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t.h1 > at:
        gaps.append((at, t.h1))
    return gaps


def read(run):
    t = getattr(run, "trace", None)
    e = getattr(run, "engine", None)
    if t is None or not e:
        return None
    spans = [(s[1], s[2]) for s in e.get("spans", ())
             if s[0] == "serve.prefill" and s[2] > t.h0 and s[1] < t.h1]
    batches = sum(1 for s, _ in spans if t.h0 <= s < t.h1)
    if not batches:
        return None
    idle = sum(max(0, min(ge, pe) - max(gs, ps)) for gs, ge in _idle(t) for ps, pe in spans)
    return idle / 1e6 / batches
