"""CUDA kernel wrapper: flash attention, forward.

Replaces ``src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd``.
The kernel is ``csrc/flash_attention.cu`` (see its header for the bound and
the design); this wrapper checks the inputs, allocates the output and
launches on the current CUDA stream.  It takes the model layout
(B, S, H, D) with any strides whose last one is 1 (and, for the kernel's
16-byte copies, a base address and other strides in whole 16-byte units),
so the q/k/v views that come out of the projections go in without a copy.
``launches`` counts the launches made, ``noncausal_launches`` those of
them with ``causal=False``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, note_launch

launches = 0
noncausal_launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
         + [ctypes.c_int, ctypes.c_void_p])
# The grid is 1-D: one block per (query tile of 64 or more rows, head, batch).
_GRID_X_MAX = 2**31 - 1
_ALIGN = 16  # bytes of one cp.async copy


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if not t.is_cuda:
            raise ValueError(f"flash_attention: the CUDA kernel needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D (B, S, heads, D), "
                             f"got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous last dimension, "
                             f"got strides {t.stride()}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, Sq, H, D), (B, Skv, K, D)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of {HEAD_DIMS}")
    K = k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a multiple of {K} kv heads")
    if min(B, Sq, k.shape[1]) < 1 or -(-Sq // 64) * H * B > _GRID_X_MAX:
        raise ValueError(f"flash_attention: B={B}, Sq={Sq}, Skv={k.shape[1]}, H={H} out of range")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # The kernel loads rows by 16-byte cp.async: the base and every
        # stride it steps by (those of dimensions longer than 1) must be
        # whole multiples of 16 bytes.
        steps = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % _ALIGN or any(s * t.element_size() % _ALIGN for s in steps):
            raise ValueError(f"flash_attention: {name} must start on a {_ALIGN}-byte boundary "
                             f"with strides of whole {_ALIGN}-byte units, got address "
                             f"{t.data_ptr():#x}, strides {t.stride()} of {t.element_size()}-byte "
                             "elements")


def flash_attention(q: "torch.Tensor", k: "torch.Tensor", v: "torch.Tensor", *,
                    causal: bool = True) -> "torch.Tensor":
    """q (B, Sq, H, D), k/v (B, Skv, K, D), H % K == 0, f32 or bf16 CUDA
    tensors, D in (16, 32, 64, 128) -> o (B, Sq, H, D), contiguous, of q's
    dtype.  ``causal`` masks to kpos <= qpos, both counted from 0."""
    global launches, noncausal_launches
    _check(q, k, v)
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}")
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K, Sq, Skv, D,
                 q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2), int(causal), stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    if not causal:
        noncausal_launches += 1
    note_launch("flash_attention")
    return o
