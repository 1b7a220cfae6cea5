"""Public paged-attention ops for decode serving + KERNELS registry."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, impl: str = "auto"):
    """q: (B, H, D); k/v_pages: (N, P, K, D); page_table: (B, M) int32;
    lengths: (B,) int32 -> (B, H, D).  ``impl``: auto|cuda|ref.  ``auto``
    launches the CUDA kernel for CUDA tensors (or raises) and takes the
    plain gather version only for CPU tensors."""
    _check_impl(impl)
    if impl == "ref" or (impl == "auto" and not q.is_cuda):
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    return _kernel.paged_attention(q, k_pages, v_pages, page_table, lengths)


def paged_attention_layers(q, k_pages, v_pages, page_table, lengths, *, impl: str = "auto"):
    """Multi-layer paged attention over ONE folded slab: q (L, B, H, D);
    k/v_pages (L, N, P, K, D); one page_table (B, M) and lengths (B,) for
    every layer -> (L, B, H, D).  On the card one launch with the layer as
    a grid axis, bit-equal to L calls of ``paged_attention``."""
    _check_impl(impl)
    L = q.shape[0]
    if k_pages.shape[0] != L or v_pages.shape[0] != L:
        raise ValueError(f"layer dims disagree: q has {L}, k_pages {k_pages.shape[0]}, "
                         f"v_pages {v_pages.shape[0]}")
    if impl == "ref" or (impl == "auto" and not q.is_cuda):
        return torch.stack([paged_attention_ref(q[i], k_pages[i], v_pages[i], page_table, lengths)
                            for i in range(L)])
    return _kernel.paged_attention_layers(q, k_pages, v_pages, page_table, lengths)


paged_attention.cuda_library = "paged_attention"
paged_attention_layers.cuda_library = "paged_attention"

KERNELS = {"paged_attention": paged_attention, "paged_attention_layers": paged_attention_layers}
