"""Public op + KERNELS registry (Program.from_file target)."""
from __future__ import annotations

from repro_torch.kernels.partition_map import kernel as _kernel
from repro_torch.kernels.partition_map.ref import partition_map_ref


def partition_map(x, *, block=None, grid=None, impl: str = "auto"):
    """``impl``: auto|cuda|ref.  ``auto`` launches the CUDA kernel for a
    CUDA tensor (or raises) and takes the plain version only for a CPU
    tensor."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")
    if impl == "ref" or (impl == "auto" and not x.is_cuda):
        return partition_map_ref(x)
    return _kernel.partition_map(x, block=block, grid=grid)


partition_map.cuda_library = "partition_map"

KERNELS = {"partition_map": partition_map, "partition_map_ref": partition_map_ref}
