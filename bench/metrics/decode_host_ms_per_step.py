"""Host milliseconds a decode step of the serving engine takes, from its
batch's preparation to its tokens sampled: ``decode_s / decode_steps`` of
the engine's counters over the window."""


def read(run):
    e = getattr(run, "engine", None)
    if not e or not e["decode_steps"]:
        return None
    return 1e3 * e["decode_s"] / e["decode_steps"]
