"""Host milliseconds a decode step of the serving engine spends sampling
its rows' tokens and handing back their state: the ``decode.sample`` spans
of the steps that ran rows in the window (``serve.decode`` spans with
``B`` over 0), over those steps.  A program that keeps no spans reads
nothing."""


def read(run):
    e = getattr(run, "engine", None)
    spans = (e or {}).get("spans", ())
    steps = {s[3] for s in spans if s[0] == "serve.decode" and s[5].get("B")}
    if not steps:
        return None
    ns = sum(s[2] - s[1] for s in spans if s[0] == "decode.sample" and s[4] in steps)
    return ns / 1e6 / len(steps)
