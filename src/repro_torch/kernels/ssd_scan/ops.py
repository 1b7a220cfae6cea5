"""Public SSD op in model layout + KERNELS registry."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_ref


def ssd(x, dt, A, B, C, D=None, *, chunk: int = 64, impl: str = "auto",
        return_state: bool = False):
    """Model layout: x (Bz, S, H, P); dt (Bz, S, H); A (H,); B/C
    (Bz, S, G, N), G dividing H (G == H: groups pre-expanded) -> y
    (Bz, S, H, P) f32, and with ``return_state`` the f32 final state
    (Bz, H, N, P).  ``impl``: auto|cuda|ref.  ``auto`` launches the CUDA
    kernel for CUDA tensors (or raises) and takes the plain sequential
    ``ssd_ref`` only for CPU tensors.  Any S goes to the kernel, which
    masks the ragged tail itself.  ``chunk`` is the reference op's Pallas
    chunk length; only its default is taken, since the kernel's chunk
    length is fixed when it is built (``csrc/ssd_scan.cu``) and the plain
    version is sequential."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")
    if chunk != 64:
        raise ValueError(f"chunk={chunk}: the kernel's chunk length is fixed in "
                         "csrc/ssd_scan.cu and the plain version is sequential; "
                         "leave chunk at 64")
    if impl == "ref" or (impl == "auto" and not x.is_cuda):
        Bz, S, H, P = x.shape
        R = H // B.shape[2]
        rows = lambda t: t.transpose(1, 2).reshape(Bz * H, S, -1)  # noqa: E731
        yg, state = ssd_ref(rows(x), dt.transpose(1, 2).reshape(Bz * H, S),
                            A.repeat(Bz), rows(B.repeat_interleave(R, dim=2)),
                            rows(C.repeat_interleave(R, dim=2)), return_state=True)
        y = yg.float().reshape(Bz, H, S, P).transpose(1, 2)
        state = state.reshape(Bz, H, *state.shape[1:])
    else:
        y, state = _kernel.ssd_scan(x, dt, A, B, C)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return (y, state) if return_state else y


ssd.cuda_library = "ssd_scan"

KERNELS = {"ssd": ssd}
