"""Model FLOPs of the training steps of the window (``benchlib.flops``:
6 x the matmul parameters a token uses, causal attention forward and
backward, no recompute) over the window's seconds times the bf16 peak
(989 TFLOP/s), in percent."""
from benchlib import flops, peaks


def read(run):
    tr = getattr(run, "train", None)
    if not tr or not tr["steps"]:
        return None
    f = flops.train_flops(run.arch, tr["batch"], tr["seq"]) * tr["steps"]
    return 100.0 * f / (tr["window_s"] * peaks.flops_peak(tr["compute_dtype"]))
