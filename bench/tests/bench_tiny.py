"""A checkout of the benchmark at tiny sizes for its own tests: a copy of
``bench/`` under a temporary root, with configurations, traffic mixes,
limits and cells of a few layers and a few tokens added as files, as a
later change adds a cell.  Runs go through ``run.main`` on the CPU."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


# Limits of the tiny training cell, set as the real cell's are but from
# readings at this size on the CPU (a leaf of a few thousand weights moves
# its norm more under bf16 than one of millions): the program read loss
# 3.8e-5 to 4.2e-5, grad norm 1.1e-3 to 1.7e-3, change 1.2e-3 to 1.5e-3;
# the fp8 control 4.8e-4, 8.1e-3, 3.9e-3.
TRAIN_TINY_LIMITS = {"loss_rel_gap": 2e-4, "grad_norm_gap": 4e-3, "change_norm_gap": 3e-3}


# Hymba-1.5B (arXiv:2411.13676) as the hybrid reference's tests take it:
# no cell serves it yet (PERF.md, Open questions), so its configuration
# lives here, not under configs/.
HYMBA_1_5B = {
    "name": "hymba-1.5b", "source": "https://arxiv.org/abs/2411.13676", "family": "hybrid",
    "arch": {"name": "hymba-1.5b", "family": "hybrid", "num_layers": 32, "d_model": 1600,
             "num_heads": 25, "num_kv_heads": 5, "d_ff": 5504, "vocab_size": 32001,
             "head_dim": 64, "norm_type": "rmsnorm", "norm_eps": 1e-06, "mlp_type": "swiglu",
             "tie_embeddings": False, "rope_type": "rope", "rope_theta": 10000.0,
             "sliding_window": 1024, "global_attn_layers": [0, 15, 31], "kv_share_group": 2,
             "meta_tokens": 128, "hybrid_attn_ssm": True,
             "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 64, "n_groups": 1,
                     "chunk": 256}},
    "serve": {"dtype": "float32", "pages": "float32", "tf32": False},
}


def _tiny_arch(conf: dict, **kw) -> dict:
    c = json.loads(json.dumps(conf))
    c["name"] = kw.pop("name")
    c["arch"].update(name=c["name"], **kw)
    return c


def make_root(tmp: Path) -> Path:
    """A checkout root under ``tmp``: ``bench/`` copied, tiny cells added
    (``olmo-tiny.chat-tiny``, ``hymba-tiny.chat-tiny``,
    ``olmo-tiny.train-tiny``), and a ``BENCHMARK.json`` listing them beside
    the real cells.  The serving cells take the real chat cell's limit; the
    training cell ``TRAIN_TINY_LIMITS``."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = root / "bench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    olmo = json.loads((b / "configs" / "olmo-1b.json").read_text())
    tiny = _tiny_arch(olmo, name="olmo-tiny", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=128, vocab_size=256)
    tiny["train"]["remat"] = "dots"  # the port's plan below 5e8 parameters
    (b / "configs" / "olmo-tiny.json").write_text(json.dumps(tiny))
    hy = HYMBA_1_5B
    hy_t = _tiny_arch(hy, name="hymba-tiny", num_layers=4, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, sliding_window=64,
                      global_attn_layers=[0, 3], meta_tokens=4,
                      ssm=dict(hy["arch"]["ssm"], head_dim=16))
    (b / "configs" / "hymba-tiny.json").write_text(json.dumps(hy_t))
    chat = json.loads((b / "traffic" / "chat.json").read_text())
    chat.update(clients=4, strata=4, decode_shapes=[1, 2, 4], trace_seconds=0.5,
                prompt={"dist": "lognormal", "median": 20, "sigma": 0.7, "min": 8, "max": 40},
                output={"dist": "lognormal", "median": 8, "sigma": 0.7, "min": 4, "max": 16})
    (b / "traffic" / "chat-tiny.json").write_text(json.dumps(chat))
    train = json.loads((b / "traffic" / "train_2k.json").read_text())
    train.update(batch=4, seq=32)
    (b / "traffic" / "train-tiny.json").write_text(json.dumps(train))
    serve_lim = json.loads((b / "limits" / "olmo-1b.chat.json").read_text())
    serve_lim["check_requests"] = 4
    train_lim = TRAIN_TINY_LIMITS
    cells = {"olmo-tiny.chat-tiny": ("olmo-tiny", "chat-tiny", serve_lim, "olmo-1b.chat"),
             "hymba-tiny.chat-tiny": ("hymba-tiny", "chat-tiny", serve_lim, "olmo-1b.chat"),
             "olmo-tiny.train-tiny": ("olmo-tiny", "train-tiny", train_lim, "olmo-1b.train_2k")}
    for name, (conf, mix, lim, like) in cells.items():
        (b / "limits" / f"{name}.json").write_text(json.dumps(lim))
        bench["workloads"].append({"name": name, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "tiny, for the harness's own tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, workload: str, seed: int = 5, seconds: float = 1.5, trace: int = 0,
             control: int = 0) -> "tuple[int, dict | None, str]":
    """``run.main`` on the CPU -> (exit code, the result line or None, stderr)."""
    import run

    out, err = io.StringIO(), io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--control", str(control)]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv, root=root, require_chip=False)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
