"""The flash kernel's share of its roofline over the prefill batches of
the traced stretch: each call's work (``counts/flash_attention.py``) at
the batch's rows and length (a hybrid's meta tokens ahead of it)."""
from benchlib import readers


def read(run):
    t = getattr(run, "trace", None)
    if t is None or not run.prefills:
        return None
    a = run.arch
    count = run.module("counts", "flash_attention")
    hd = a.get("head_dim") or a["d_model"] // a["num_heads"]
    meta = int(a.get("meta_tokens") or 0)
    work = [(op, count.work(p[2], p[3] + meta, a["num_heads"], a["num_kv_heads"], hd, 4))
            for op, p in readers.prefill_calls(run, "flash_attention")]
    return readers.roofline(work, run.config["serve"]["dtype"])
