"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside
this file, then loaded with ``ctypes``.  The hash is taken over the source
and the flags, so an edited source is never served by a stale library.
The build happens at first use (``load``) or for several libraries at
once, one ``nvcc`` process each, all started together (``load_all``).

Flags: ``-O3`` and no ``--use_fast_math``: partition_map needs the
precise ``sinf``/``cosf`` for |x| in the hundreds, mandelbrot rounds
every operation on its own (``__fmul_rn``/``__fadd_rn``) to match the
plain PyTorch version bit for bit, paged_attention's softmax and
ssd_scan's decays use the precise ``expf``, and flash_attention's softmax
the precise ``exp2f``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0, with CUDA's message for the code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NAMES", "build_dir", "check", "load", "load_all"]

NAMES = ("stencil", "partition_map", "mandelbrot", "flash_attention", "ssd_scan",
         "paged_attention")

CSRC = Path(__file__).resolve().parent / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: "dict[str, ctypes.CDLL]" = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """Where the libraries go (listed in ``.gitignore``);
    ``REPRO_TORCH_BUILD_DIR`` overrides it."""
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR") or Path(__file__).resolve().parent / "build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path] | None":
    """Start nvcc for ``name`` unless its library is built already."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file


def _open(name: str) -> "ctypes.CDLL":
    lib = ctypes.CDLL(str(_target(name)))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def load_all(names=NAMES) -> "dict[str, ctypes.CDLL]":
    """Build every library of ``names`` in parallel (one nvcc each) and
    load them; libraries already loaded or built are reused."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = {n: _start(n) for n in todo}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
        for n in todo:
            _libs[n] = _open(n)
        return {n: _libs[n] for n in names}


def load(name: str) -> "ctypes.CDLL":
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else load_all((name,))[name]


def check(lib: "ctypes.CDLL", err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
