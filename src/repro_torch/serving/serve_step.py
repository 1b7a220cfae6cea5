"""Serving steps: prefill (forward + decode cache) and greedy decode, the
scheduler-routed fan-out of independent batches, and the continuous-batching
decode engine: the port of ``src/repro/serving/serve_step.py``.

``make_prefill`` and ``make_serve_step`` close over the params, for every
ported family.  On a CUDA device the prefill's attention runs the
hand-written flash kernel and the ssm prefill's scans run the ``ssd_scan``
kernel; the decode steps are plain PyTorch.

Batch fan-out (DESIGN.md §9): ``route_batches`` asks the placement policy
for a device per batch, percolates the batch there and runs it on that
device's ops queue; ``make_serve_fanout`` specialises it to decode steps.

Continuous batching (DESIGN.md §12): ``make_serve_engine`` builds the
``RequestEngine`` that assembles batches from individual decode requests.
Remote localities and registered kernel names wait for the parcel port
(ROADMAP.md Queue 1 item 10) and are refused.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_model
from repro_torch.serving.engine import (_PARCELS, RequestEngine, _leaf_tensor, to_device,
                                        tree_flatten, tree_map)

__all__ = ["cache_to_rows", "make_prefill", "make_serve_engine", "make_serve_fanout",
           "make_serve_step", "route_batches", "rows_to_cache"]


def make_serve_step(cfg, params):
    """Returns ``serve_step(cache, tokens, pos) -> (next_tokens, logits,
    cache)``: greedy decode of one token.  ``next_tokens`` (B, 1) int32,
    ``logits`` (B, 1, V) f32; the cache is updated in place and returned."""
    m = get_model(cfg)

    def serve_step(cache, tokens, pos: int):
        logits, cache = m.decode_step(cfg, params, cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill(cfg, params, *, q_block: int = 512, impl: str = "auto"):
    """Returns ``prefill(batch) -> (logits_last, cache)``: logits (B, 1, V)
    f32 of the last position and the prompt's cache.  Dense, moe, vlm: kv
    {'k', 'v'}: (L, B, S, K, hd), to be copied into a decode cache of S +
    new slots; encdec: {'self', 'cross'}, as its ``forward`` returns them.
    ssm: the decode cache itself, {'state', 'conv'} (the real state the
    prompt leaves, not the reference ``forward``'s zeros).  ``impl="ref"``
    keeps attention or the scan on the plain path; ``q_block`` is the
    plain attention's query block."""
    m = get_model(cfg)
    kw = {} if cfg.family == "ssm" else {"q_block": q_block}  # the attention families'

    def prefill(batch):
        logits, _aux, cache = m.forward(cfg, params, batch, return_kv=True, last_only=True,
                                        impl=impl, **kw)
        return logits, cache

    return prefill


def route_batches(fn, batches, scheduler=None, percolate: bool = True, cluster=None):
    """Fan independent batches across devices via the placement scheduler.

    For each batch (any pytree of arrays or tensors) the scheduler picks a
    device — scoring the batch's leaves, so ``affinity`` keeps
    cache-resident requests where their bytes already live — the batch is
    percolated there (every leaf a tensor on that device; ``percolate=
    False`` hands it through untouched) and ``fn(batch)`` runs on that
    device's ops queue.  Returns one future per batch; join with
    ``repro_torch.core.wait_all``.

    A cluster, a registered kernel name (``str``) and a batch placed on a
    remote locality need the parcel port (ROADMAP.md Queue 1 item 10) and
    raise ``NotImplementedError``.
    """
    from repro_torch.core.scheduler import get_scheduler

    if cluster is not None:
        raise NotImplementedError(
            f"route_batches over a cluster needs the parcel port, not ported yet ({_PARCELS})")
    if isinstance(fn, str):
        raise NotImplementedError(
            f"route_batches with a registered kernel name ({fn!r}) needs the parcel port's "
            f"kernel registry, not ported yet ({_PARCELS}); pass the callable")
    sched = scheduler if scheduler is not None else get_scheduler()
    futs = []
    for b in batches:
        dev = sched.select(args=tree_flatten(b)[0])
        if getattr(dev, "is_remote_proxy", False):
            raise NotImplementedError(
                f"route_batches placed a batch on {dev.key}, a remote locality: the work "
                f"would travel as a parcel, not ported yet ({_PARCELS})")

        def _run(b=b, dev=dev):
            return fn(to_device(b, dev) if percolate else b)

        futs.append(dev.ops_queue.submit(_run))
    return futs


def _moved(a, src: int, dst: int):
    t = a if isinstance(a, torch.Tensor) else _leaf_tensor(a)
    return torch.movedim(t, src, dst)


def cache_to_rows(cache, batch_axis: int = 1):
    """Model-layout cache -> engine request layout: the batch axis moved to
    the FRONT of every leaf, where ``RequestEngine`` concatenates (a view;
    numpy leaves become tensors).  The dtype is kept, bfloat16 included,
    and a request's rows round-trip submit → batch → slice bit-identically.
    The paged serving path does not go through these adapters: its cache
    never leaves the device as whole-cache rows."""
    return tree_map(lambda a: _moved(a, batch_axis, 0), cache)


def rows_to_cache(cache, batch_axis: int = 1):
    """Inverse of ``cache_to_rows``."""
    return tree_map(lambda a: _moved(a, 0, batch_axis), cache)


def make_serve_engine(cfg, params, plan=None, cache_batch_axis: int = 1, **engine_kwargs):
    """A continuous-batching ``RequestEngine`` serving decode requests for
    one model (DESIGN.md §12).

    Each request is ``{"cache": cache_to_rows(cache), "tokens": (b, 1)
    int32, "pos": 0-d int}``, the per-sequence slice of ``serve_step``'s
    state (``b`` is usually 1).  Model caches batch along
    ``cache_batch_axis`` (axis 1 in the layer-major layouts), so requests
    carry them through ``cache_to_rows``.  The engine concatenates
    compatible requests (``pos`` is a broadcast leaf, so only
    same-position steps share a micro-batch), pads to a bucket, runs ONE
    decode step, and resolves every caller's future with its slice of
    ``{"next", "logits", "cache"}`` (cache in request layout — feed it
    straight into the next ``submit``).

    ``params`` are closed over.  The graph route is off by default, as in
    the reference: every request's whole cache is fed anew each step, and
    the step reads ``pos`` on the host (the cache is sliced at it), which
    no captured graph can do.  ``plan`` is accepted for the reference's
    signature and unused.
    """
    step = make_serve_step(cfg, params)

    def decode(batch):
        cache = rows_to_cache(batch["cache"], cache_batch_axis)
        nxt, logits, cache = step(cache, batch["tokens"], int(batch["pos"]))
        return {"next": nxt, "logits": logits, "cache": cache_to_rows(cache, cache_batch_axis)}

    engine_kwargs.setdefault("graph", False)
    engine_kwargs.setdefault("name", f"serve:{getattr(cfg, 'name', 'model')}")
    return RequestEngine({"decode": decode}, **engine_kwargs)


def make_serve_fanout(cfg, plan=None):
    """Scheduler-routed decode: returns ``fanout(requests, scheduler=None)``
    where each request is a ``(params, cache, tokens, pos)`` tuple; every
    request decodes one token with its own params on the device the
    policy places it on.  Returns one future per request (value:
    ``(next_tokens, logits, cache)`` — the full ``serve_step`` contract;
    the cache, percolated to the device, is updated in place).  ``plan``
    is accepted for the reference's signature and unused."""
    def step(req):
        params, cache, tokens, pos = req
        return make_serve_step(cfg, params)(cache, tokens, int(pos))

    def fanout(requests, scheduler=None):
        return route_batches(step, requests, scheduler=scheduler)

    return fanout
