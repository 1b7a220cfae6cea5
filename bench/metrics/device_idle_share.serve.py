"""Share of the traced stretch of a serving window in which no operation
ran on the device, on any stream, in percent."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
