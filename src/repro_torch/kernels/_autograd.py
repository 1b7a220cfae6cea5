"""The hand-written kernels inside autograd.

A kernel wrapper fills a ``torch.empty`` through ``ctypes``: its output has
no ``grad_fn``, so a loss computed through it would silently leave out
every term that flows through the kernel.  ``kernel_with_plain_grad`` puts
the kernel on the forward path and takes the gradients of the kernel's
plain PyTorch version: the backward recomputes the plain version on the
saved inputs and differentiates it.  Those are the gradients the JAX
reference takes, since it differentiates its plain forward whole and has
no backward kernel.

``refuse_grad`` is the raw wrappers' guard: called where an input requires
grad and grad mode is on, they raise instead of returning a tensor outside
the graph.

Under a device mesh the inputs are ``DTensor``s, which a kernel cannot
read.  ``kernel_with_plain_grad`` then runs the kernel (and its plain
gradient) through ``distribution.sharding.on_local_shards``: on each
rank's local shards wherever the inputs are sharded only along dims the
function treats independently, which the caller names (``shard_dims``:
batch rows, attention heads), on gathered tensors along every other mesh
dim.  The kernel launches either way: there is no fallback to the plain
version.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Sequence

import torch

__all__ = ["kernel_with_plain_grad", "refuse_grad"]


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires grad: the kernel ``name`` has no backward."""
    if _needs_grad(tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires grad; call it "
            "through repro_torch.kernels._autograd.kernel_with_plain_grad (as "
            "models.layers.attention and models.ssm do) or under torch.no_grad()")


class _PlainGrad(torch.autograd.Function):
    """forward: ``kernel(*inputs)``; backward: the gradient of
    ``plain(*inputs)``, recomputed under grad on the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        out = kernel(*inputs)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, needs)]
            outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [x for x in xs if x.requires_grad]
            got = (torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
        it = iter(got)
        return (None, None, *[next(it) if n else None for n in needs])


ShardDims = Mapping[str, "tuple[Sequence[int | None], Sequence[int | None]]"]


def kernel_with_plain_grad(kernel: Callable, plain: Callable, *inputs: "torch.Tensor",
                           shard_dims: "ShardDims | None" = None):
    """``kernel(*inputs)``, inside autograd when grad mode is on and an
    input requires grad: the backward is that of ``plain(*inputs)``, which
    computes the same function (a tensor or a tuple of tensors, of the
    kernel's shapes) in plain PyTorch.  Otherwise the kernel is called
    directly.  ``shard_dims`` matters only for ``DTensor`` inputs, as
    ``on_local_shards`` reads it."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in inputs):
        from repro_torch.distribution.sharding import on_local_shards

        return on_local_shards(functools.partial(kernel_with_plain_grad, kernel, plain), inputs,
                               shard_dims or {})
    if _needs_grad(inputs):
        return _PlainGrad.apply(kernel, plain, *inputs)
    return kernel(*inputs)
