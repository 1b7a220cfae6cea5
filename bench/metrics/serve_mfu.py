"""Model FLOPs of every prefill and decoded token the serving engine ran
in the window (``benchlib.flops``; the engine's calls as the harness
stamped them), over the window's seconds times the f32 peak (495 TFLOP/s,
``benchlib.peaks``), in percent."""
from benchlib import flops, peaks


def read(run):
    if not getattr(run, "prefills", None) and not getattr(run, "steps", None):
        return None
    a = run.arch
    total = sum(rows * flops.prefill_flops(a, T) for _, _, rows, T in run.prefills)
    total += sum(flops.decode_flops(a, int(n)) for _, _, lens in run.steps for n in lens)
    return 100.0 * total / (run.window_s * peaks.flops_peak(run.config["serve"]["dtype"]))
