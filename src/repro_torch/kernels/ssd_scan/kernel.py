"""CUDA kernel wrapper: Mamba-2 SSD scan, forward.

Replaces ``src/repro/kernels/ssd_scan/kernel.py:ssd_scan``.  The kernel is
``csrc/ssd_scan.cu`` (see its header for the bound and the design): three
kernels, launched back to back by one C call, over every chunk of every
row at once, handing states between chunks through a workspace.  This
wrapper checks the inputs, allocates the outputs and the workspace (sized
by the library's ``ssd_scan_f32_workspace``, so the chunk length lives in
the ``.cu`` alone) and launches on the current CUDA stream.  It takes the
model layout with any strides whose last one is 1, so the x/B/C views
sliced out of the conv output go in without a copy, and grouped B/C are
read by group, never expanded.  ``launches`` counts the calls made;
``kernel_launches`` the CUDA kernels they launched, as the C entry reports
them (three a call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, note_launch
from repro_torch.kernels._autograd import refuse_grad

launches = 0
kernel_launches = 0

MAX_P, MAX_N = 128, 256
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 13
         + [ctypes.c_void_p] * 2)
_INT_MAX = 2**31 - 1


def _check(x, dt, A, B, C) -> None:
    named = (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 4), ("C", C, 4))
    for name, t, rank in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssd_scan: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: the kernel takes float32 inputs, {name} is {t.dtype} "
                            "(cast before the call, as the model does)")
        if t.dim() != rank:
            raise ValueError(f"ssd_scan: {name} must be {rank}-D, got {tuple(t.shape)}")
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (Bz, S, H) or tuple(A.shape) != (H,) or B.shape != C.shape
            or tuple(B.shape[:2]) != (Bz, S)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} do not fit "
                         "(Bz, S, H, P), (Bz, S, H), (H,), (Bz, S, G, N)")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads are not a multiple of {G} groups")
    if not 1 <= P <= MAX_P or not 1 <= N <= MAX_N:
        raise ValueError(f"ssd_scan: head dim P={P} (at most {MAX_P}) or state dim N={N} "
                         f"(at most {MAX_N}) out of range")
    if min(Bz, S) < 1 or Bz * H > _INT_MAX:
        raise ValueError(f"ssd_scan: Bz={Bz}, S={S}, H={H} out of range")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a contiguous last dimension, "
                             f"got strides {t.stride()}")
    for name, t, _ in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan: the CUDA kernel needs CUDA tensors, {name} is on {t.device}")
        if t.device != x.device:
            raise ValueError("ssd_scan: the inputs lie on different devices")


def _bind(lib: "ctypes.CDLL") -> "ctypes.CDLL":
    lib.ssd_scan_f32.argtypes, lib.ssd_scan_f32.restype = _ARGS, ctypes.c_int
    lib.ssd_scan_f32_workspace.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_f32_workspace.restype = ctypes.c_longlong
    for fn in (lib.ssd_scan_f32_chunk, lib.ssd_scan_f32_launched):
        fn.argtypes, fn.restype = [], ctypes.c_int
    return lib


def chunk_length() -> int:
    """The chunk length the kernel library was built with."""
    return _bind(_build.load("ssd_scan")).ssd_scan_f32_chunk()


def workspace_bytes(Bz: int, S: int, H: int, N: int, P: int) -> int:
    """Bytes of the workspace one call at this shape allocates."""
    return _bind(_build.load("ssd_scan")).ssd_scan_f32_workspace(Bz, S, H, N, P)


def ssd_scan(x: "torch.Tensor", dt: "torch.Tensor", A: "torch.Tensor", B: "torch.Tensor",
             C: "torch.Tensor", lib: "ctypes.CDLL | None" = None
             ) -> "tuple[torch.Tensor, torch.Tensor]":
    """x (Bz, S, H, P), dt (Bz, S, H) (post-softplus), A (H,), B/C
    (Bz, S, G, N) with H % G == 0, all f32 CUDA tensors, P <= 128, N <= 256
    -> y (Bz, S, H, P) and the final state (Bz, H, N, P), both f32 and
    contiguous; the state starts at zero.  No D term (the caller adds it).
    ``lib`` is a build of ``csrc/ssd_scan.cu``, by default the main one,
    built after the inputs pass their checks.  Raises ``RuntimeError`` when
    grad mode is on and an input requires grad (the kernel has no backward:
    ``kernels._autograd``)."""
    global launches, kernel_launches
    refuse_grad("ssd_scan", x, dt, A, B, C)
    _check(x, dt, A, B, C)
    lib = _bind(lib or _build.load("ssd_scan"))
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bz, H, N, P), dtype=torch.float32, device=x.device)
    work = torch.empty(lib.ssd_scan_f32_workspace(Bz, S, H, N, P), dtype=torch.uint8,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(), Bz, S, H, G, P, N,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
            A.stride(0), B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1),
            C.stride(2), work.data_ptr(), stream)
        launched = lib.ssd_scan_f32_launched()
    _build.check(lib, err, "ssd_scan")
    # the library call comes first: a ctypes call inside `+=` lets another
    # thread's call in between the read and the write, and its count is lost
    kernel_launches += launched
    launches += 1
    note_launch("ssd_scan")
    return y, state
