"""Batched serving: prefill a batch of prompts, then greedy-decode (the
PyTorch port of ``examples/serve_batch.py``).

Uses the same ``make_serve_step`` the decode_* dry-run cells trace, on the
reference's reduced config (``smoke``), with the KV cache updated in place
between steps.  Then checks the greedy tokens against the argmax of one
teacher-forced ``forward`` over prompt + generated tokens, wherever its top
two logits are more than 1e-3 apart (dense and ssm configs: a MoE's
capacity drops, an encoder-decoder's frames and a hybrid's meta tokens,
which decode steps from an empty cache never see, make the two differ by
design).  It runs on the card; ``--cpu`` runs it on the CPU device instead.
Weights are drawn from a seeded ``torch.Generator``, not the reference's JAX
key, so the tokens are the port's own.

    python3 examples/torch_serve_batch.py [--cpu] [--arch qwen2-moe-a2.7b] [--tokens 16]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.serve_step import make_serve_step  # noqa: E402

CHECKED_FAMILIES = ("dense", "ssm")


def main(cpu: bool = False, arch: str = "olmo-1b", batch: int = 4, prompt_len: int = 8,
         tokens: int = 16) -> int:
    if not cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    device = torch.device("cpu" if cpu else "cuda")
    cfg = smoke(get_config(arch))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    max_seq = prompt_len + tokens + 1
    cache = m.init_cache(cfg, batch, max_seq, device=device, dtype=torch.float32)
    serve = make_serve_step(cfg, params)

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    prompt_d = torch.from_numpy(prompt).to(device=device, dtype=torch.int32)

    # prefill through repeated decode steps (smoke-sized; production uses
    # make_prefill, which the prefill_32k dry-run cells trace)
    with torch.no_grad():
        tok = prompt_d[:, :1]
        for p in range(prompt_len):
            nxt, _logits, cache = serve(cache, tok, p)
            tok = prompt_d[:, p + 1:p + 2] if p + 1 < prompt_len else nxt
        first = tok[:, 0].cpu().numpy()  # the prompt's own next token

        generated = []
        t0 = time.perf_counter()
        for i in range(tokens):
            nxt, _logits, cache = serve(cache, tok, prompt_len + i)
            generated.append(nxt[:, 0])
            tok = nxt
        gen = torch.stack(generated, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0

    print(f"arch={cfg.name} batch={batch} on {device}")
    for b in range(batch):
        print(f"  prompt {prompt[b].tolist()} -> {gen[b].tolist()}")
    print(f"{tokens} tokens x {batch} seqs in {dt:.2f}s ({tokens * batch / dt:.1f} tok/s)")

    if cfg.family not in CHECKED_FAMILIES:
        print(f"no forward check for the {cfg.family} family")
        return 0
    # every greedy token, the prompt's next one first, against the argmax of
    # the logits one forward gives at the position before it
    got = np.concatenate([first[:, None], gen], axis=1)
    seq = torch.from_numpy(np.concatenate([prompt, got[:, :-1]], axis=1)).to(device)
    with torch.no_grad():
        logits = m.forward(cfg, params, {"tokens": seq}, impl="ref")[0][:, prompt_len - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-3).cpu().numpy()
    want = torch.argmax(logits, dim=-1).cpu().numpy()
    bad = int(((got != want) & clear).sum())
    if bad:
        print(f"{bad} greedy tokens differ from the forward's argmax", file=sys.stderr)
        return 1
    print(f"greedy tokens equal the forward's argmax ({int(clear.sum())} of {got.size} "
          "clear of a near-tie)")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    a = ap.parse_args()
    sys.exit(main(a.cpu, a.arch, a.batch, a.prompt_len, a.tokens))
