"""Print the losses of the train phases of ``chip_smoke.py`` (one JSON
line), to hold two trees' training to each other bit for bit.

The same calls the smoke makes, with the smoke's own settings (imported
from ``chip_smoke.py``): its two train models whole through
``launch.train.train`` (``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
``TRAIN_SEQ`` tokens, seed 0), and the first one's first
``TRAIN_MESH_STEPS`` steps under a one-rank ("data", "model") mesh.  Run
it from a checkout, or with ``PYTHONPATH`` at another tree's ``src`` to
print that tree's:

    PYTHONPATH=src python3 tools/train_losses.py > a.json
    PYTHONPATH=/path/to/other/src python3 tools/train_losses.py > b.json

Needs a card (the losses are the card's; the kernels build at first use).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (TRAIN_ARCH, TRAIN_BATCH, TRAIN_MESH_STEPS,  # noqa: E402
                        TRAIN_SEQ, TRAIN_SSM_ARCH, TRAIN_STEPS)


def main() -> int:
    import torch

    from repro_torch.core.executor import reset_runtime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train

    if not torch.cuda.is_available():
        print("train_losses: no CUDA device", file=sys.stderr)
        return 1
    kw = dict(use_smoke=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=0, seed=0,
              device="cuda")
    out = {"torch": torch.__version__}
    for name, arch in (("train", TRAIN_ARCH), ("train_ssm", TRAIN_SSM_ARCH)):
        out[name] = train(arch, steps=TRAIN_STEPS, **kw)["losses"]
        torch.cuda.empty_cache()
    out["train_mesh"] = train(TRAIN_ARCH, steps=TRAIN_MESH_STEPS, mesh=make_host_mesh(1, 1),
                              schedule_total=TRAIN_STEPS, **kw)["losses"]
    reset_runtime()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
