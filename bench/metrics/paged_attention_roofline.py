"""paged_attention's share of its roofline over the decode steps of the
traced stretch: each call's work (``counts/paged_attention.py``) from the
lengths of the step that launched it, the real rows only."""
from benchlib import readers
from benchlib.trace import attribute


def read(run):
    t = getattr(run, "trace", None)
    if t is None or not run.steps:
        return None
    a = run.arch
    count = run.module("counts", "paged_attention")
    hd = a.get("head_dim") or a["d_model"] // a["num_heads"]
    stamps = [(s[0], s) for s in sorted(run.steps, key=lambda s: s[0])]
    pairs = attribute(readers.kernel_ops(run, "paged_attention"), stamps)
    work = [(op, count.work([int(n) + 1 for n in step[2]], a["num_heads"], a["num_kv_heads"], hd,
                            4, run.page_size)) for op, step in pairs]
    return readers.roofline(work, run.config["serve"]["pages"])
