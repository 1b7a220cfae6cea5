"""Device milliseconds of the optimizer a training step: the operations
launched from inside the step's ``train.adamw`` range (by the launches'
correlation ids), over the ranges the trace holds."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None:
        return None
    ops, n = t.launched_in("train.adamw")
    if not n or not ops:
        return None
    return 1e3 * sum((o[2] - o[1]) for o in ops) / 1e9 / n
