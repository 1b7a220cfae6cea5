"""No run loads the JAX package or its stack, compared by whole top-level
names: ``repro_torch`` is the program and passes, ``repro`` does not."""
import subprocess
import sys

from bench_tiny import BENCH, make_root
from benchlib import result


def test_bench_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro.models" in result.forbidden_modules()


def test_bench_run_imports_no_jax_in_a_process_of_its_own(tmp_path):
    root = make_root(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "from bench_tiny import run_cell\n"
        "import pathlib\n"
        f"rc, res, err = run_cell(pathlib.Path({str(root)!r}), 'olmo-tiny.chat-tiny',"
        " seconds=1.0)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad, 'correct': res and res['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "bad": [], "correct": True}


def test_bench_run_refuses_when_the_jax_stack_is_loaded(tmp_path, monkeypatch):
    from bench_tiny import run_cell

    root = make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", seconds=1.0)
    assert rc == 3 and res is None and "jax" in err


def test_bench_run_without_a_card_prints_no_result(tmp_path):
    """The harness's own look for a chip: this sandbox has none."""
    import torch

    if torch.cuda.is_available():
        return
    root = make_root(tmp_path)
    out = subprocess.run([sys.executable, str(root / "bench" / "run.py"), "--workload",
                          "olmo-1b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode != 0 and out.stdout.strip() == ""
