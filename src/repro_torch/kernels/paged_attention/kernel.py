"""CUDA kernel wrapper: paged attention, decode.

Replaces ``src/repro/kernels/paged_attention/kernel.py:paged_attention_bhd``
and the per-layer loop of its ``ops.paged_attention_layers``.  The kernel
is ``csrc/paged_attention.cu`` (see its header for the bound and the
design: split-K over a row's pages, merged inside a thread-block cluster);
this wrapper checks the inputs, allocates the output and launches on the
current CUDA stream.  q and the pages may have any strides whose last one
is 1, so the query view of a (B, 1, H, D) projection and one layer of a
folded slab go in without a copy; the C entry takes the kernel's vector
instantiation where the bases and strides allow it, else its scalar one.
``launches`` counts the calls made and ``kernel_launches`` the CUDA
kernels they launched as the C entry reports them (one a call).  Of the
last call, as the C entry recorded its launch: ``last_load_width``, the
elements a lane loaded at once (4: vector, 1: scalar); ``last_blocks``,
the blocks of its grid; ``last_cluster``, the blocks of each cluster.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, note_launch
from repro_torch.kernels._autograd import refuse_grad

launches = 0
kernel_launches = 0
last_load_width = 0
last_blocks = 0
last_cluster = 0

MAX_D = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 13
         + [ctypes.c_void_p])
_GRID_YZ_MAX = 65535  # B and L are the grid's y and z extents (x: splits x kv heads)


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    """q (L, B, H, D), pages (L, N, P, K, D), table (B, M), lengths (B,)."""
    named = (("q", q, 4), ("k_pages", k_pages, 5), ("v_pages", v_pages, 5),
             ("page_table", page_table, 2), ("lengths", lengths, 1))
    for name, t, rank in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"paged_attention: {name} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if not t.is_cuda:
            raise ValueError(f"paged_attention: the CUDA kernel needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dim() != rank:
            raise ValueError(f"paged_attention: {name} must be {rank}-D, got {tuple(t.shape)}")
    if len({t.device for _, t, _ in named}) != 1:
        raise ValueError("paged_attention: the inputs lie on different devices")
    if q.dtype not in _SUFFIX or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q and the pages must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_attention: page_table and lengths must be int32, got "
                        f"{page_table.dtype}, {lengths.dtype}")
    L, B, H, D = q.shape
    _, N, P, K, Dk = k_pages.shape
    if (v_pages.shape != k_pages.shape or k_pages.shape[0] != L or Dk != D
            or page_table.shape[0] != B or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)} do not fit "
                         "(L, B, H, D), (L, N, P, K, D), (B, M), (B,)")
    if K < 1 or H % K:
        raise ValueError(f"paged_attention: {H} query heads are not a multiple of {K} kv heads")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"paged_attention: head dim {D} is not in 1..{MAX_D}")
    if min(L, B, H, N, P, page_table.shape[1]) < 1 or max(L, B) > _GRID_YZ_MAX:
        raise ValueError(f"paged_attention: L={L}, B={B}, H={H}, N={N}, P={P}, "
                         f"M={page_table.shape[1]} out of range")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table)):
        if t.stride(-1) != 1:
            raise ValueError(f"paged_attention: {name} needs a contiguous last dimension, "
                             f"got strides {t.stride()}")


def _lib() -> "ctypes.CDLL":
    lib = _build.load("paged_attention")
    if lib.paged_attention_blocks.restype is not ctypes.c_longlong:
        for fn in (lib.paged_attention_launched, lib.paged_attention_load_width,
                   lib.paged_attention_splits, lib.paged_attention_cluster):
            fn.argtypes, fn.restype = [], ctypes.c_int
        for dtype in _SUFFIX.values():
            fn = getattr(lib, f"paged_attention_{dtype}")
            fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        lib.paged_attention_blocks.argtypes = []
        lib.paged_attention_blocks.restype = ctypes.c_longlong
    return lib


def splits() -> int:
    """The blocks each (kv head, row, layer) is split over, a constant of
    the kernel's source.  Builds the library if it is not built yet."""
    return _lib().paged_attention_splits()


def _launch(q, k_pages, v_pages, page_table, lengths) -> "torch.Tensor":
    global launches, kernel_launches, last_load_width, last_blocks, last_cluster
    # decode only: the kernel has no backward (kernels._autograd)
    refuse_grad("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, page_table, lengths)
    lib = _lib()
    fn = getattr(lib, f"paged_attention_{_SUFFIX[q.dtype]}")
    L, B, H, D = q.shape
    _, _, P, K, _ = k_pages.shape
    o = torch.empty((L, B, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
                 lengths.data_ptr(), o.data_ptr(), L, B, H, K, P, page_table.shape[1], D,
                 q.stride(0), q.stride(1), q.stride(2), *k_pages.stride()[:4],
                 *v_pages.stride()[:4], page_table.stride(0), lengths.stride(0), stream)
    _build.check(lib, err, "paged_attention")
    launched = lib.paged_attention_launched()  # before `+=`: see ssd_scan's wrapper
    launches += 1
    note_launch("paged_attention")
    kernel_launches += launched
    last_load_width = lib.paged_attention_load_width()
    last_blocks = lib.paged_attention_blocks()
    last_cluster = lib.paged_attention_cluster()
    return o


def paged_attention(q: "torch.Tensor", k_pages: "torch.Tensor", v_pages: "torch.Tensor",
                    page_table: "torch.Tensor", lengths: "torch.Tensor") -> "torch.Tensor":
    """q (B, H, D); k/v_pages (N, P, K, D), H % K == 0, f32 or bf16 CUDA
    tensors, D <= 256; page_table (B, M) and lengths (B,) int32 on the same
    device -> o (B, H, D), contiguous, of q's dtype.  Row b attends over
    its first min(lengths[b], M * P) tokens; a length-0 row gives 0."""
    for name, t, rank in (("q", q, 3), ("k_pages", k_pages, 4), ("v_pages", v_pages, 4)):
        if isinstance(t, torch.Tensor) and t.dim() != rank:
            raise ValueError(f"paged_attention: {name} must be {rank}-D, got {tuple(t.shape)}")
    return _launch(q[None], k_pages[None], v_pages[None], page_table, lengths)[0]


def paged_attention_layers(q: "torch.Tensor", k_pages: "torch.Tensor", v_pages: "torch.Tensor",
                           page_table: "torch.Tensor", lengths: "torch.Tensor") -> "torch.Tensor":
    """The folded form, in ONE launch: q (L, B, H, D), k/v_pages (L, N, P,
    K, D) under one table -> (L, B, H, D), bit-equal to L calls of
    ``paged_attention``."""
    return _launch(q, k_pages, v_pages, page_table, lengths)
