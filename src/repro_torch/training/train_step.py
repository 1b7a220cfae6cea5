"""Train-step factory: microbatched gradient accumulation into f32
buffers + AdamW, driven by a ``CellPlan`` (``src/repro/training/
train_step.py`` on PyTorch).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``, the reference's functional step.  The f32
master params are the leaves the gradient is taken for; the plan's
``compute_dtype`` bfloat16 casts every f32 leaf of ndim >= 2 to bf16 for
the forward (the reference's rule, on the same stacked tree), and the
cast's backward brings the gradient back to f32.  A batch of n
microbatches runs n forward/backward passes in a Python loop (the
reference scans), each gradient added into f32 buffers, then divided by
n.  On a CUDA tensor the model's attention and SSD scans run the
hand-written kernels in the forward and the plain versions' gradients in
the backward (``kernels._autograd``).

Under a device mesh the params, moments and batch are ``DTensor``s
(``launch.train``'s ``mesh=``) and the step runs on them unchanged, inside
``implicit_replication``: a plain tensor the model makes (positions,
masks, a constant) counts as replicated on the mesh.  The kernels run on
local shards (``kernels._autograd``); the metrics are ``DTensor``s.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from repro_torch.models import batch_logical_specs, get_model
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state

__all__ = ["make_init", "make_train_step"]

F32 = torch.float32
# profiler ranges of a step's parts, read by tools/profile_torch_train.py
TRAIN_SPANS = ("train.forward", "train.backward", "train.adamw")


def _split_micro(batch: dict, logical: dict, n: int) -> dict:
    """Reshape each batch leaf's *batch* axis (found via its logical spec)
    from (B, ...) to (n, B/n, ...) moved to the front: microbatch i is
    rows [i B/n, (i+1) B/n).  A ``DTensor`` leaf, its rows sharded in
    blocks over ranks, splits as (B/n, n) instead, microbatch i being rows
    i, n + i, ...: each rank splits its own rows, where the contiguous
    split would put a microbatch on a few ranks (``DTensor`` cannot view
    that).  The step's mean over microbatches is the same."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in batch.items():
        names = logical[k]
        bi = names.index("batch")
        B = v.shape[bi]
        if B % n:
            raise ValueError(f"_split_micro: {k} has batch {B}, not a multiple of {n} "
                             "microbatches")
        if isinstance(v, DTensor):
            r = v.reshape(v.shape[:bi] + (B // n, n) + v.shape[bi + 1:])
            out[k] = torch.movedim(r, bi + 1, 0)
        else:
            r = v.reshape(v.shape[:bi] + (n, B // n) + v.shape[bi + 1:])
            out[k] = torch.movedim(r, bi, 0)
    return out


def make_train_step(cfg, shape, opt_cfg: OptConfig, plan, *, impl: str = "auto",
                    donate: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics {"loss", "gnorm", "lr"} (0-dim f32 tensors).

    ``impl`` goes to the model (``ref`` keeps attention and scans on the
    plain path).  ``donate``: the step updates ``params`` and ``opt_state``
    in place and returns them (the reference launcher's ``donate_argnums=
    (0, 1)``): one copy of the params and moments lives on the card."""
    m = get_model(cfg)
    logical = batch_logical_specs(cfg, shape)
    n = plan.num_microbatches
    compute_dtype = torch.bfloat16 if plan.compute_dtype == "bfloat16" else F32

    def cast(p):
        """Mixed precision: matmul weights compute in bf16; f32 master
        copies stay in the optimizer; 1-D params (norms/biases) stay f32."""
        if compute_dtype == F32:
            return p
        return tree_map(lambda x: x.to(compute_dtype) if (x.dtype == F32 and x.ndim >= 2)
                        else x, p)

    def train_step(params, opt_state, batch):
        flat, treedef = tree_flatten(params)
        with _mesh_context(flat):
            return _step(params, flat, treedef, opt_state, batch)

    def _step(params, flat, treedef, opt_state, batch):
        masters = [p.detach().requires_grad_(True) for p in flat]

        def loss_and_grads(mb):
            with record_function(TRAIN_SPANS[0]):
                loss = m.loss_fn(cfg, cast(tree_unflatten(treedef, masters)), mb,
                                 remat=plan.remat, q_block=plan.q_block, impl=impl)
            with record_function(TRAIN_SPANS[1]):
                grads = torch.autograd.grad(loss, masters, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(masters, grads)]

        if n == 1:
            loss, grads = loss_and_grads(batch)
        else:
            stacked = _split_micro(batch, logical, n)
            loss = torch.zeros((), dtype=F32, device=flat[0].device)
            grads = [torch.zeros_like(p, dtype=F32) for p in flat]
            for i in range(n):
                l, g = loss_and_grads({k: v[i] for k, v in stacked.items()})
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(F32))
                del g
            loss = loss / n
            grads = [g / n for g in grads]
        del masters
        with record_function(TRAIN_SPANS[2]):
            new_params, new_state, om = adamw_update(opt_cfg, params,
                                                     tree_unflatten(treedef, grads), opt_state,
                                                     donate=donate)
        return new_params, new_state, {"loss": loss, **om}

    return train_step


def _mesh_context(leaves):
    """``implicit_replication`` when the params' ``leaves`` are ``DTensor``s."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if leaves and isinstance(leaves[0], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


def make_init(cfg, opt_cfg: OptConfig, dtype=F32, *, device="cuda"):
    """Returns ``init(seed) -> (params, opt_state)`` on ``device`` (the card
    unless the caller asks for another); the params are the model's
    ``init`` drawn from a generator seeded with ``seed`` (the reference
    takes a JAX key)."""
    m = get_model(cfg)

    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        params = m.init(cfg, generator=gen, device=device, dtype=dtype)
        return params, init_opt_state(params)

    return init
