"""``correct`` of a served model: the plain reference run over a sample of
the finished requests, drawn from the seed with the longest among them.

For each sampled request the reference runs once over its prompt and the
tokens it was served (teacher forcing), and each served token is held to
the reference's best at its position: the gap by which the served token's
logit lies below the reference's largest.  Greedy decoding serves the
argmax, so the gap is 0 where the two agree and at most the rounding of a
near tie where they do not.  The widest gap over the sample is the number
compared.  The control (``--control 1``) reads the same gap for the token
that the reference with TF32 products puts first, at each position of the
same prompts and tokens, and is judged by the same limits
(``control_correct``).
"""
from __future__ import annotations

import numpy as np
import torch


def _gaps(logits, tokens) -> "torch.Tensor":
    best = logits.max(dim=-1).values
    return best - logits.gather(1, tokens[:, None])[:, 0]


def verdict(widest: float, short: int, lim: dict) -> "tuple[dict, bool]":
    """The numbers compared, each beside its limit, and whether all hold."""
    checks = {"max_logit_gap": {"value": widest, "limit": lim["max_logit_gap"]},
              "short_or_missing": {"value": short, "limit": 0}}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def check_served(cell, ref, params, done, outs, reqs, a) -> dict:
    """``correct`` of the requests finished in the window; with
    ``cell.control`` also ``control_correct``, the control's widest gap
    over the same sample judged by the same limits."""
    lim = cell.limits
    meta = int(a.get("meta_tokens") or 0)
    window = a.get("sliding_window")
    lines, short = [], 0
    for i in done:
        if i not in outs or len(outs[i]) != reqs.lengths(i)[1]:
            short += 1
    pool = [i for i in done if i in outs]
    if not pool:
        checks, _ = verdict(float("inf"), short, lim)
        return {"correct": False, "lines": ["check: no request finished in the window"],
                "checks": checks}
    longest = max(pool, key=lambda i: (len(outs[i]), -i))
    rest = [i for i in pool if i != longest]
    rng = np.random.default_rng([cell.seed, 99])
    k = min(int(lim["check_requests"]) - 1, len(rest))
    sample = [longest] + [rest[j] for j in sorted(rng.choice(len(rest), size=k, replace=False))]
    dev = next(iter(_leaves(params))).device
    widest, widest_ctrl, served = 0.0, 0.0, 0
    prev = torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad():
        for i in sample:
            prompt = reqs[i][0]
            out = np.asarray(outs[i], dtype=np.int64)
            seq = torch.from_numpy(np.concatenate([prompt.astype(np.int64), out[:-1]])).to(dev)
            pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out), device=dev)
            tok = torch.from_numpy(out).to(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            z = ref.logits(a, params, seq, pos)
            gap = float(_gaps(z, tok).max())
            widest = max(widest, gap)
            served += len(out)
            line = (f"check request {i}: prompt {len(prompt)} served {len(out)} "
                    f"gap {gap!r}")
            if window:
                line += f" (meta + prompt {'over' if meta + len(prompt) > window else 'within'}"
                line += f" the window {window})"
            if cell.control:
                torch.backends.cuda.matmul.allow_tf32 = True
                zc = ref.logits(a, params, seq, pos)
                cg = float(_gaps(z, zc.argmax(dim=-1)).max())
                widest_ctrl = max(widest_ctrl, cg)
                line += f" control_tf32 {cg!r}"
            lines.append(line)
    torch.backends.cuda.matmul.allow_tf32 = prev
    lines.append(f"check: {len(sample)} requests, {served} served tokens, widest gap {widest!r}"
                 + (f", control (tf32) widest gap {widest_ctrl!r}" if cell.control else ""))
    checks, correct = verdict(widest, short, lim)
    out = {"correct": correct, "checks": checks, "lines": lines}
    if cell.control:
        ctrl, out["control_correct"] = verdict(widest_ctrl, short, lim)
        lines += [f"control {n}: {c['value']!r} limit {c['limit']!r}" for n, c in ctrl.items()]
        lines.append(f"control_correct: {out['control_correct']}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
