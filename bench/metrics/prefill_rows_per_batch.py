"""Rows a prefill batch of the serving engine held: the engine's own
counters over the window, ``(rows - decode_rows) / prefill_batches``."""


def read(run):
    e = getattr(run, "engine", None)
    if not e or not e["prefill_batches"]:
        return None
    return (e["rows"] - e["decode_rows"]) / e["prefill_batches"]
