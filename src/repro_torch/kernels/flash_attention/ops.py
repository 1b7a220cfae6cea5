"""Public flash-attention op in model layout (B, S, H, D) + KERNELS registry."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) -> (B, Sq, H, D).  ``impl``:
    auto|cuda|ref.  ``auto`` launches the CUDA kernel for CUDA tensors (or
    raises) and takes the plain version only for CPU tensors.  Any Sq and
    Skv go to the kernel, which masks ragged tails itself."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")
    if impl == "ref" or (impl == "auto" and not q.is_cuda):
        return flash_attention_ref(q, k, v, causal=causal)
    return _kernel.flash_attention(q, k, v, causal=causal)


flash_attention.cuda_library = "flash_attention"

KERNELS = {"flash_attention": flash_attention}
