"""Real rows a decode step of the serving engine held (padding rows not
counted): the engine's counters over the window, ``decode_rows /
decode_steps``."""


def read(run):
    e = getattr(run, "engine", None)
    if not e or not e["decode_steps"]:
        return None
    return e["decode_rows"] / e["decode_steps"]
