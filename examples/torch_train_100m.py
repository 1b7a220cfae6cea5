"""End-to-end driver on the PyTorch port: train a ~100M-parameter dense LM.

The whole path on one device: the futurized data pipeline, the microbatched
AdamW train step (bf16 compute, f32 masters, the plan's remat), async
checkpointing, the straggler monitor and resume.  It runs on the card unless
``--device`` names another device.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --steps 5 --tiny --device cpu

--tiny drops to a ~10M config for quick verification.  Loss decreasing over
the run is asserted at exit (runs of 20 steps or more).
"""
import argparse
import os
import sys
import tempfile
import types
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.configs as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

# ~100M params: 12L x d640 x ff2560 + 32k vocab
ARCH_100M = dict(
    num_layers=12, d_model=640, num_heads=10, num_kv_heads=10,
    d_ff=2560, vocab_size=32000, head_dim=64, max_seq=1024,
)
ARCH_TINY = dict(
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=1024, vocab_size=8192, head_dim=64, max_seq=512,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args()

    base = get_config("olmo-1b")  # family template (dense, swiglu, rope)
    cfg = replace(base, name="dense-100m", **(ARCH_TINY if args.tiny else ARCH_100M))
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {args.device}")

    # register the custom config so train() can fetch it
    mod = types.ModuleType("repro_torch.configs._custom100m")
    mod.CONFIG = cfg
    sys.modules[mod.__name__] = mod
    C._MODULES = {**C._MODULES, cfg.name: mod.__name__}

    out = train(
        cfg.name,
        use_smoke=False,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        resume=args.resume,
        log_every=max(1, args.steps // 50),
        device=args.device,
    )
    first = sum(out["losses"][:3]) / max(len(out["losses"][:3]), 1)
    last = sum(out["losses"][-3:]) / max(len(out["losses"][-3:]), 1)
    print(f"loss {first:.4f} -> {last:.4f}")
    if args.steps >= 20:  # too few steps are still inside LR warm-up
        assert last < first, "loss did not decrease"


if __name__ == "__main__":
    main()
