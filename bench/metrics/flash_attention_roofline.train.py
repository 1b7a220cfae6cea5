"""The flash kernel's share of its roofline in the traced training steps
(the forward and the recompute launch it; the backward is the plain
path's): each call's work (``counts/flash_attention.py``) at the step's
rows and length, its operands in the compute dtype."""
from benchlib import readers

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    t = getattr(run, "trace", None)
    tr = getattr(run, "train", None)
    if t is None or not tr:
        return None
    a = run.arch
    count = run.module("counts", "flash_attention")
    hd = a.get("head_dim") or a["d_model"] // a["num_heads"]
    dt = tr["compute_dtype"]
    w = count.work(tr["batch"], tr["seq"], a["num_heads"], a["num_kv_heads"], hd, ITEMSIZE[dt])
    return readers.roofline([(op, w) for op in readers.kernel_ops(run, "flash_attention")], dt)
