"""Model FLOPs of the served and trained work, from a configuration's sizes.

A corrected copy of ``model_flops`` of the port's ``analysis/roofline.py``:
hybrid attention counts every layer (global layers over the whole causal
prefix, windowed ones over at most ``sliding_window`` keys), the SSM counts
the recurrence's work a token (state update and readout), not a chunked
algorithm's, and the unembedding is counted where it runs (a prefill takes
logits at its last position only).  Multiply-adds count 2.

Per layer, ``matmul_params`` are the weights a token multiplies: attention
q, k, v, o (k and v only in a layer producing its own K/V), the MLP, and a
hybrid layer's SSM projections (z, xBC, dt, out).
"""
from __future__ import annotations


def _hd(a: dict) -> int:
    return a.get("head_dim") or a["d_model"] // a["num_heads"]


def is_global(a: dict, l: int) -> bool:
    return l in tuple(a.get("global_attn_layers") or ())


def kv_producer(a: dict, l: int) -> int:
    g = int(a.get("kv_share_group") or 1)
    if is_global(a, l) or g <= 1:
        return l
    base = l - (l % g)
    return l if is_global(a, base) else base


def ssm_dims(a: dict) -> dict:
    s = a["ssm"]
    d_inner = s["expand"] * a["d_model"]
    return {"d_inner": d_inner, "heads": d_inner // s["head_dim"], "P": s["head_dim"],
            "G": s["n_groups"], "N": s["d_state"], "conv": s["d_conv"],
            "conv_dim": d_inner + 2 * s["n_groups"] * s["d_state"]}


def layer_matmul_params(a: dict, l: int) -> int:
    d, H, K, hd = a["d_model"], a["num_heads"], a["num_kv_heads"], _hd(a)
    n = 2 * d * H * hd
    if kv_producer(a, l) == l:
        n += 2 * d * K * hd
    n += (3 if a["mlp_type"] in ("swiglu", "geglu") else 2) * d * a["d_ff"]
    if a["family"] == "hybrid":
        s = ssm_dims(a)
        n += d * s["d_inner"] + d * s["conv_dim"] + d * s["heads"] + s["d_inner"] * d
    return n


def matmul_params(a: dict) -> int:
    """Every layer's weights a token multiplies."""
    return sum(layer_matmul_params(a, l) for l in range(a["num_layers"]))


def unembed_flops(a: dict) -> int:
    return 2 * a["d_model"] * a["vocab_size"]


def ssm_token_flops(a: dict) -> int:
    """One token's SSM mixer outside the projections, all layers: the causal
    depthwise conv, and a head's recurrence h = exp(dt A) h + dt B x^T (3NP +
    N), readout C h (2NP) and skip D x (2P)."""
    if a["family"] != "hybrid":
        return 0
    s = ssm_dims(a)
    per = 2 * s["conv"] * s["conv_dim"] + s["heads"] * (5 * s["N"] * s["P"] + s["N"] + 2 * s["P"])
    return a["num_layers"] * per


def paged_layers(a: dict) -> int:
    """Layers that attend through the page pool in a decode step: a
    hybrid's global layers where it has a window (its windowed layers read
    a ring), every layer otherwise."""
    if a.get("sliding_window") and a["family"] == "hybrid":
        return len(a.get("global_attn_layers") or ())
    return a["num_layers"]


def attention_keys(a: dict, l: int, pos: int) -> int:
    """Keys that the query at absolute position ``pos`` attends to in layer ``l``."""
    w = a.get("sliding_window")
    if w and not is_global(a, l) and a["family"] == "hybrid":
        return min(pos + 1, w)
    return pos + 1


def _causal_keys(S: int, w: "int | None") -> int:
    """Sum over positions 0..S-1 of the keys each attends to."""
    if not w or S <= w:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def attention_flops_prefill(a: dict, S: int) -> int:
    """Causal attention of one sequence of ``S`` positions, all layers: QK^T
    and PV, 4 H hd a query-key pair."""
    H, hd, w = a["num_heads"], _hd(a), a.get("sliding_window")
    total = 0
    for l in range(a["num_layers"]):
        win = w if (w and a["family"] == "hybrid" and not is_global(a, l)) else None
        total += 4 * H * hd * _causal_keys(S, win)
    return total


def prefill_flops(a: dict, T: int) -> int:
    """A prompt of ``T`` tokens (a hybrid's meta tokens ahead of it), logits
    at the last position."""
    S = T + int(a.get("meta_tokens") or 0)
    return (2 * matmul_params(a) * S + unembed_flops(a) + attention_flops_prefill(a, S)
            + ssm_token_flops(a) * S)


def decode_flops(a: dict, resident: int) -> int:
    """One decoded token of a row holding ``resident`` positions (meta
    included) before it: it attends over ``resident + 1``."""
    H, hd = a["num_heads"], _hd(a)
    attn = sum(4 * H * hd * attention_keys(a, l, resident) for l in range(a["num_layers"]))
    return 2 * matmul_params(a) + unembed_flops(a) + attn + ssm_token_flops(a)


def train_flops(a: dict, batch: int, seq: int) -> int:
    """One training step: 6 x the matmul parameters a token uses (the
    unembedding among them), plus causal attention forward and backward (3x
    the forward) in every layer; recompute is not counted."""
    tokens = batch * seq
    mat = 6 * (matmul_params(a) + a["d_model"] * a["vocab_size"]) * tokens
    return mat + 3 * batch * attention_flops_prefill(a, seq) + 3 * ssm_token_flops(a) * tokens
