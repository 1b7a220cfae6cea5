"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit).  A kernel's operations are held to the peak of its operand
dtype: an f32 kernel to the TF32 tensor-core rate, which an f32-accurate
3xTF32 split draws on, never to the 67 TFLOP/s of the CUDA cores (a later
f32-accurate kernel on the tensor cores would read over 100% there)."""
from __future__ import annotations

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def flops_peak(dtype: str) -> float:
    return FLOPS[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """A kernel's least time: the larger of its operations over its dtype's
    peak and its bytes over the HBM rate."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
