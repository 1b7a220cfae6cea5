"""On the card only (marked ``cuda``; each test decides inside itself
whether a card is present): a serving cell run with ``--control 1``
through the harness's own path (the engine, the window, ``check_served``
and the cell's limits) comes out correct, and its control, the plain
reference with TF32 products in the program's place, comes out not
correct.  OLMo-1B whole, the cell's own lengths and limits, fewer
clients and a short window."""
import json

import pytest
import torch

from bench_tiny import make_root, run_cell

CELLS = {"olmo-1b.chat": {"clients": 8, "decode_shapes": [1, 2, 4, 8], "check_requests": 8},
         "olmo-1b.code": {"clients": 16, "decode_shapes": [1, 2, 4, 8, 16],
                          "check_requests": 32}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bench_tf32_control_is_not_correct_where_the_program_is(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only on the card")
    root = make_root(tmp_path)
    b = root / "bench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    real = next(w for w in bench["workloads"] if w["name"] == cell)
    small = dict(CELLS[cell])
    mix = json.loads((b / "traffic" / f"{real['traffic']}.json").read_text())
    mix.update(clients=small["clients"], decode_shapes=small["decode_shapes"], ramp_seconds=2.0)
    (b / "traffic" / f"{real['traffic']}-card.json").write_text(json.dumps(mix))
    lim = json.loads((b / "limits" / f"{cell}.json").read_text())
    lim["check_requests"] = small["check_requests"]
    name = f"{cell}-card"
    (b / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench["workloads"].append(dict(real, name=name, traffic=f"{real['traffic']}-card"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(root, name, seed=2**31 + 21, seconds=4.0, control=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["control_correct"] is False, err[-3000:]
