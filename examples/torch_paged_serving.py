"""Paged-KV serving demo (the PyTorch port of ``examples/paged_serving.py``).

A toy GQA language model is served by ``PagedServeEngine`` through its
legacy two-callable contract: prompts of assorted lengths are prefilled in
token-budgeted groups, their KV lands in fixed-size pages of a device's
``PagePool``, and a continuous decode lane steps every resident sequence
over its page table through the hand-written paged-attention kernel, one
CUDA graph a warm row count.  The same prompts then run one at a time for
comparison, and the generated tokens are asserted identical: paging and
batching change the schedule, never the math.  The weights are the
reference's (``np.random.default_rng(0)``).  It runs on the card; ``--cpu``
runs it on the CPU device instead (the kernel's plain version).

    python3 examples/torch_paged_serving.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PAGE = 8
MAXLEN = 64
VOCAB = 128
HEADS = 4
KV_HEADS = 2
HEAD_DIM = 16
PROMPT_LENS = (5, 5, 5, 12, 12, 12, 30, 30)
NEW_TOKENS = 8


def make_model(device, impl="auto"):
    """(prefill_fn, decode_fn) of the legacy contract on ``device``; the
    decode's paged attention runs as ``impl`` (auto|cuda|ref) says."""
    from repro_torch.kernels.paged_attention.ops import paged_attention

    Dm = HEADS * HEAD_DIM
    rng = np.random.default_rng(0)
    s = 1.0 / np.sqrt(Dm)

    def weight(*shape):  # f32, as the reference's jnp.asarray makes them
        w = np.asarray(rng.normal(size=shape).astype(np.float32) * s, dtype=np.float32)
        return torch.from_numpy(w).to(device)

    emb = weight(VOCAB, Dm)
    wq = weight(Dm, Dm)
    wk = weight(Dm, KV_HEADS * HEAD_DIM)
    wv = weight(Dm, KV_HEADS * HEAD_DIM)
    wu = weight(Dm, VOCAB)

    def prefill_fn(tokens):
        x = emb[tokens.long()]                            # (B, T, Dm)
        B, T, _ = x.shape
        k = (x @ wk).reshape(B, T, KV_HEADS, HEAD_DIM)
        v = (x @ wv).reshape(B, T, KV_HEADS, HEAD_DIM)
        q = (x[:, -1] @ wq).reshape(B, KV_HEADS, HEADS // KV_HEADS, HEAD_DIM)
        sc = torch.einsum("bkrd,btkd->bkrt", q, k) / np.sqrt(HEAD_DIM)
        o = torch.einsum("bkrt,btkd->bkrd", torch.softmax(sc, -1), v)
        nxt = torch.argmax(o.reshape(B, Dm) @ wu, -1).to(torch.int32)
        return k[:, None], v[:, None], nxt                # KV gains a layer axis

    def decode_fn(kp, vp, tokens, positions, tables, lengths):
        x = emb[tokens.long()]                            # (b, Dm)
        b = tokens.shape[0]
        q = (x @ wq).reshape(b, HEADS, HEAD_DIM)
        k = (x @ wk).reshape(b, KV_HEADS, HEAD_DIM)
        v = (x @ wv).reshape(b, KV_HEADS, HEAD_DIM)
        page = tables[torch.arange(b, device=tokens.device), (positions // PAGE).long()].long()
        slot = (positions % PAGE).long()
        kp[0, page, slot] = k                             # scatter the new token, in place
        vp[0, page, slot] = v
        o = paged_attention(q, kp[0], vp[0], tables, lengths + 1, impl=impl)
        nxt = torch.argmax(o.reshape(b, Dm) @ wu, -1).to(torch.int32)
        return kp, vp, nxt

    return prefill_fn, decode_fn


def prompts():
    # prefill groups same-length prompts (no padding inside a group), so the
    # stream repeats a few lengths the way real traffic repeats templates
    return [np.arange(n, dtype=np.int32) % VOCAB for n in PROMPT_LENS]


def serve(dev, model, label, warm=False, on_start=None, **policies):
    """Every prompt through a legacy-contract engine on ``dev`` -> (tokens,
    metrics).  ``warm`` serves the first prompt once beforehand and resets
    the metrics after it; ``on_start()``, if given, is called just before
    the prompts are submitted.  The metrics' ``wall_s`` runs from there to
    the engine's drain."""
    from repro_torch.core import Scheduler
    from repro_torch.serving import PagedKVCache, PagedServeEngine, PageSpec

    kv = PagedKVCache(PageSpec(1, PAGE, KV_HEADS, HEAD_DIM), devices=[dev], pool_pages=64)
    with PagedServeEngine(kv, *model, max_seq_len=MAXLEN, scheduler=Scheduler([dev]),
                          contract="legacy", name=label, **policies) as eng:
        if warm:
            eng.submit(prompts()[0], max_new_tokens=NEW_TOKENS).get(timeout=300)
            eng.drain()
            eng.reset_metrics()
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts()]
        outs = [np.asarray(f.get(timeout=300)) for f in futs]
        eng.drain()
        m = {**eng.metrics(), "wall_s": time.perf_counter() - t0}
    return outs, m


def policies(serial: bool) -> dict:
    """The one-at-a-time schedule, or grouped prefill and continuous
    batched decode at warm counts 1, 2, 4, 8."""
    from repro_torch.serving import LanePolicy

    if serial:
        return {"prefill": LanePolicy(max_batch=1, max_delay_s=0.0),
                "decode": LanePolicy(max_batch=1, max_delay_s=0.0)}
    return {"prefill": LanePolicy(max_batch=8, max_delay_s=0.05, token_budget=128),
            "decode": LanePolicy(max_batch=8, max_delay_s=0.02), "decode_shapes": (1, 2, 4, 8)}


def main(cpu: bool = False) -> int:
    from repro_torch.core import get_all_devices

    devices = get_all_devices(1, 0, platform="cpu" if cpu else "cuda").get()
    if not devices:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    dev = devices[0]
    model = make_model(dev.torch_device)
    runs = {}
    for label, serial in (("serial", True), ("paged", False)):
        outs, m = serve(dev, model, label, **policies(serial))
        runs[label] = outs
        print(f"{label:>10}: {m['prefill_batches']} prefill batches, "
              f"{m['decode_steps']} decode steps, "
              f"waste {m['padding_waste']:.2f}, "
              f"spills {m['spills']}")
    if not all(np.array_equal(a, b) for a, b in zip(runs["serial"], runs["paged"])):
        print("schedules diverged", file=sys.stderr)
        return 1
    print("tokens identical across schedules OK")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    sys.exit(main(ap.parse_args().cpu))
