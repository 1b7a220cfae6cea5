"""Build the flash-attention kernel at other tile shapes, check and time them.

    python3 tools/sweep_torch_flash.py [--variants JSON]

Each variant rewrites the ``Tiles<...>`` constants of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (BQ, BK, STAGES,
MIN_BLOCKS, MT per dtype: ``{"name": {"bf16": {"BK": 64}, "f32": {...}}}``)
and is built with the port's own nvcc flags, all variants at once, into a
temporary directory.  For each it prints the registers and spills that
``-Xptxas -v`` reports at D 128, checks it against the plain version on
small ragged shapes and at the serve shape (f32 within 2e-4, bf16 within
``bf16_bound``), and times it at ``chip_smoke.py``'s serve shape (B 4,
S 2000, H 16, D 128, causal) and GQA shape beside SDPA, in one JSON line
per dtype.  The variant ``chosen`` is the source as it stands.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import bf16_bound, flash_attention_ref  # noqa: E402

SOURCE = _build.CSRC / "flash_attention.cu"
TYPES = {"bf16": "__nv_bfloat16", "f32": "float"}
# The shapes tried before the tiles were chosen: one row tile a warp,
# BK 64, BQ 256 and a third stage.
VARIANTS = {
    "chosen": {},
    "mt1": {"bf16": {"MT": 1}, "f32": {"MT": 1, "BQ": 64, "BK": 32}},
    "bk64": {"bf16": {"BK": 64, "MIN_BLOCKS": 1}, "f32": {"BK": 32, "MIN_BLOCKS": 1}},
    "bq256": {"bf16": {"BQ": 256, "MIN_BLOCKS": 1}, "f32": {"BQ": 256, "MIN_BLOCKS": 1}},
    "stages3": {"bf16": {"STAGES": 3}, "f32": {"STAGES": 3, "MIN_BLOCKS": 1}},
}
CHECKS = [(1, 1, 1, 2, 1, 128), (2, 100, 200, 8, 2, 64), (1, 200, 100, 4, 1, 32),
          (2, 129, 129, 4, 2, 16), (1, 300, 300, 36, 4, 128)]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(src: str, tiles: dict) -> str:
    """``src`` with the ``Tiles`` fields of ``tiles`` ({"bf16": {...}})
    replaced."""
    for dt, fields in tiles.items():
        pat = re.compile(r"(struct Tiles<%s> \{\s*static constexpr int )([^;]*);" % TYPES[dt])
        m = pat.search(src)
        if m is None:
            raise ValueError(f"no Tiles<{TYPES[dt]}> in {SOURCE}")
        cur = dict(kv.split(" = ") for kv in m.group(2).split(", "))
        unknown = set(fields) - set(cur)
        if unknown:
            raise ValueError(f"{dt}: no tile field {sorted(unknown)}; fields: {sorted(cur)}")
        cur.update({k: str(v) for k, v in fields.items()})
        src = src[:m.start(2)] + ", ".join(f"{k} = {v}" for k, v in cur.items()) + src[m.end(2):]
    return src


def build(variants: dict, out: Path) -> "dict[str, tuple[ctypes.CDLL, str]]":
    procs = {}
    for name, tiles in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(SOURCE.read_text(), tiles))
        cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, log)
    return libs


def launch(lib, q, k, v, causal=True):
    """The wrapper's launch, on another build of the kernel."""
    fn = getattr(lib, f"flash_attention_{flash_kernel._SUFFIX[q.dtype]}")
    fn.argtypes, fn.restype = flash_kernel._ARGS, ctypes.c_int
    B, Sq, H, D = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, k.shape[2], Sq,
             k.shape[1], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention")
    return o


def qkv(B, Sq, Skv, H, K, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]


def max_error(lib, q, k, v, causal) -> float:
    """Largest error against the plain version: absolute in f32 (limit
    2e-4), as a share of ``bf16_bound`` in bf16 (limit 1)."""
    got, want = launch(lib, q, k, v, causal), flash_attention_ref(q, k, v, causal=causal)
    diff = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        return float(diff.max())
    return float((diff / bf16_bound(q, k, v, want, causal=causal)).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", type=json.loads, default=VARIANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_torch_flash: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        libs = build(args.variants, Path(tmp))
        for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            limit = 2e-4 if dtype == torch.float32 else 1.0
            B, S, H, K, D = 4, 2000, 16, 16, 128
            serve = qkv(B, S, S, H, K, D, dtype, 7)
            gqa = qkv(*smoke.GQA_SHAPE[:2], smoke.GQA_SHAPE[1], *smoke.GQA_SHAPE[2:], dtype, 7)
            flops = 4 * D * smoke.attention_pairs(B, H, S, S, True)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                *(x.transpose(1, 2) for x in serve), is_causal=True)
            row = {"dtype": dt, "sdpa_ms": smoke.cuda_ms(sdpa, 10), "variants": {}}
            for name, (lib, log) in libs.items():
                errs = [max_error(lib, *qkv(*c, dtype, i), causal)
                        for i, c in enumerate(CHECKS) for causal in (True, False)]
                errs.append(max_error(lib, *serve, True))
                ms = smoke.cuda_ms(lambda: launch(lib, *serve), 10)
                func = ("flash_fwdIf" if dtype == torch.float32
                        else "flash_fwdI13__nv_bfloat16") + f"Li{D}E"
                row["variants"][name] = {
                    "tiles": args.variants[name].get(dt, {}), "ok": max(errs) <= limit,
                    "max_err": max(errs), "ms": ms, "tflops": flops / ms / 1e9,
                    "x_sdpa": ms / row["sdpa_ms"],
                    "gqa_ms": smoke.cuda_ms(lambda: launch(lib, *gqa), 10),
                    "ptxas_d128": smoke.ptxas_usage(log, func)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
