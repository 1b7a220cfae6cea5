"""Public op + KERNELS registry for the futurized runtime
(``device.create_program_with_file(".../stencil/ops.py")``)."""
from __future__ import annotations

from repro_torch.kernels.stencil import kernel as _kernel
from repro_torch.kernels.stencil.ref import stencil_ref


def stencil(x, *, block=None, grid=None, impl: str = "auto"):
    """3-point stencil. ``impl``: auto|cuda|ref.  ``auto`` launches the
    CUDA kernel for a CUDA tensor (or raises) and takes the plain version
    only for a CPU tensor.  ``block``/``grid`` come from the launch
    geometry (Dim3 -> tuple) of ``Program.run``."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")
    if impl == "ref" or (impl == "auto" and not x.is_cuda):
        return stencil_ref(x)
    return _kernel.stencil(x, block=block, grid=grid)


stencil.cuda_library = "stencil"

KERNELS = {"stencil": stencil, "stencil_ref": stencil_ref}
