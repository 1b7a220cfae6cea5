"""Roofline terms per (arch x shape x mesh) from the dry-run records
(``src/repro/analysis/roofline.py`` with an H100's constants).

Hardware model, per GPU (NVIDIA H100 SXM5 80GB at 700 W, from its
datasheet): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, and 50 GB/s of network a GPU (one 400 Gb/s NDR InfiniBand NIC
each).  The production mesh's 16-wide model axis spans two 8-GPU nodes,
so every collective of it leaves its node and runs at the NIC's rate,
not NVLink's.  Terms (seconds a step, a device; the op table is one
device's, so its quantities already are):

    compute    = flops / 989e12
    memory     = hbm_bytes / 3.35e12
    collective = collective_wire_bytes / 50e9

MODEL_FLOPS: analytic useful work = 6*N_active*T (train) / 2*N_active*T
(inference) + the attention (or SSD) sequence-interaction term; the ratio
MODEL_FLOPS / counted FLOPs exposes remat and plain-attention waste.
``model_flops`` and ``hbm_floor_bytes`` are the reference's, copied.

``python -m repro_torch.analysis.roofline [--multi-pod]`` prints the
table of the records under ``results/torch_dryrun/``.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import get_config, get_shape

PEAK_FLOPS = 989e12  # dense bf16 / GPU
HBM_BW = 3.35e12  # B/s / GPU
LINK_BW = 50e9  # B/s / GPU: one 400 Gb/s NIC

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"


def load_records(multi_pod: bool = False) -> "list[dict]":
    tag = "multipod" if multi_pod else "singlepod"
    out = []
    for p in sorted(RESULTS_DIR.glob(f"*__{tag}.json")):
        out.append(json.loads(p.read_text()))
    return out


# ---------------------------------------------------------------------------
# analytic useful FLOPs
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """Global useful FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count()
    L = cfg.num_layers
    H = cfg.num_heads
    hd = cfg.hd if H else 0  # attention-free archs have no heads

    if shape.kind == "train":
        T = B * S
        mat = 6.0 * N * T  # fwd 2NT + bwd 4NT
        # causal attention: QK^T + PV, halved by causality, x3 for backward
        attn = 3.0 * 2.0 * B * S * S * H * hd if not cfg.attn_free else 0.0
        if cfg.sliding_window and cfg.family == "hybrid":
            w = cfg.sliding_window
            n_glob = len(cfg.global_attn_layers)
            attn = 3.0 * 2.0 * B * S * H * hd * (
                (L - n_glob) / L * min(2 * w, S) + n_glob / L * S
            )
        ssd = 0.0
        if cfg.ssm is not None:
            s = cfg.ssm
            Hs, P, Nst, Lc = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
            # intra (2 L_c (P+N) per tok) + state in/out (4 N P per tok)
            ssd = 3.0 * B * S * Hs * (2.0 * min(Lc, S) * (P + Nst) + 4.0 * Nst * P) * L
        return mat + attn * (L if not cfg.attn_free and cfg.family != "hybrid" else 1.0) + ssd

    if shape.kind == "prefill":
        T = B * S
        mat = 2.0 * N * T
        attn = 2.0 * B * S * S * H * hd * L if not cfg.attn_free else 0.0
        return mat + attn

    # decode: one token against an S-token cache
    T = B
    mat = 2.0 * N * T
    attn = 4.0 * B * S * H * hd * L if not cfg.attn_free else 0.0
    if cfg.family == "hybrid" and cfg.sliding_window:
        n_glob = len(cfg.global_attn_layers)
        attn = 4.0 * B * H * hd * (n_glob * S + (L - n_glob) * min(cfg.sliding_window, S))
    ssd = 0.0
    if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        Hs, P, Nst = s.n_heads(cfg.d_model), s.head_dim, s.d_state
        ssd = 4.0 * B * Hs * Nst * P * L
    return mat + attn + ssd


def hbm_floor_bytes(cfg, shape, devices: int) -> float:
    """Per-chip lower bound on HBM traffic: weights once + KV cache once."""
    n = cfg.active_param_count()
    wbytes = 2.0 * n  # bf16
    kv = 0.0
    if shape.kind == "decode" and not cfg.attn_free:
        kv = 2.0 * 2.0 * cfg.num_layers * shape.global_batch * shape.seq_len * cfg.num_kv_heads * cfg.hd
    return (wbytes + kv) / devices


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------

def roofline_terms(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    shape = get_shape(rec["shape"])
    dev = rec["devices"]
    hlo = rec["hlo"]  # the op table's analysis (the reference's key)

    compute_s = hlo["flops"] / PEAK_FLOPS
    memory_s = hlo["hbm_bytes"] / HBM_BW
    collective_s = hlo["collective_wire_bytes"] / LINK_BW

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms, key=terms.get)
    step = max(terms.values())

    mf_global = model_flops(cfg, shape)
    mf_dev = mf_global / dev
    ratio = mf_dev / hlo["flops"] if hlo["flops"] else 0.0

    # MFU-style score: useful flops / (step time x peak)
    mfu = mf_dev / (step * PEAK_FLOPS) if step > 0 else 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)

    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bound": bound,
        "step_seconds": step,
        "model_flops_global": mf_global,
        "model_flops_ratio": ratio,
        "mfu": mfu,
        "tokens_per_s": tokens / step if step > 0 else 0.0,
        "roofline_fraction": terms["compute"] / step if step > 0 else 0.0,
    }


def summarize(multi_pod: bool = False) -> str:
    lines = [
        "| arch | shape | bound | compute s | memory s | collective s | model/counted | MFU | tok/s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load_records(multi_pod):
        if "error" in rec:
            lines.append(f"| {rec['arch']} | {rec['shape']} | ERROR | | | | | | |")
            continue
        t = roofline_terms(rec)
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | **{t['bound']}** | {t['compute_s']:.2e} "
            f"| {t['memory_s']:.2e} | {t['collective_s']:.2e} | {t['model_flops_ratio']:.2f} "
            f"| {t['mfu'] * 100:.1f}% | {t['tokens_per_s']:.3g} |"
        )
    return "\n".join(lines)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    print(summarize(args.multi_pod))


if __name__ == "__main__":
    main()
