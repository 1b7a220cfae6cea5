"""The port's five examples that follow the reference's
``examples/{quickstart,overlap_pipeline,async_pipeline,serve_batch,
paged_serving}.py``, run on the CPU device (``main(cpu=True)``, the
kernels' plain versions): each returns 0 and prints its check line.
``torch_paged_serving``'s tokens equal the reference example's, its toy
model and engine run by the JAX package on the same prompts.  The examples
import nothing of JAX or the reference package."""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

CHECK_LINES = {
    "torch_quickstart": "sum of 1000 ones = 1000",
    "torch_overlap_pipeline": "(>1 == overlap really happened)",
    "torch_async_pipeline": "futurized results equal the synchronous ones",
    "torch_serve_batch": "greedy tokens equal the forward's argmax",
    "torch_paged_serving": "tokens identical across schedules OK",
}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(CHECK_LINES))
def test_torch_example_runs_on_the_cpu(name, capsys):
    assert _load(name).main(cpu=True) == 0
    assert CHECK_LINES[name] in capsys.readouterr().out


def test_torch_paged_serving_tokens_equal_the_reference_example():
    from repro.core import Scheduler as JaxScheduler
    from repro.core import get_all_devices as jax_get_all_devices
    from repro.serving import LanePolicy as JaxLanePolicy
    from repro.serving import PagedKVCache as JaxPagedKVCache
    from repro.serving import PagedServeEngine as JaxPagedServeEngine
    from repro.serving import PageSpec as JaxPageSpec
    from repro_torch.core import get_all_devices

    port, ref = _load("torch_paged_serving"), _load("paged_serving")
    geometry = ("PAGE", "MAXLEN", "VOCAB", "HEADS", "KV_HEADS", "HEAD_DIM")
    assert [getattr(port, n) for n in geometry] == [getattr(ref, n) for n in geometry]
    dev = get_all_devices(1, 0, platform="cpu").get()[0]
    model = port.make_model(dev.torch_device)
    jdev = jax_get_all_devices(1, 0).get()[0]
    jmodel = ref.make_model()
    for serial in (True, False):
        got, _ = port.serve(dev, model, "t-example", **port.policies(serial))
        pol = port.policies(serial)
        jpol = {"prefill": JaxLanePolicy(**vars(pol["prefill"])),
                "decode": JaxLanePolicy(**vars(pol["decode"]))}
        if "decode_shapes" in pol:
            jpol["decode_shapes"] = pol["decode_shapes"]
        jkv = JaxPagedKVCache(JaxPageSpec(1, ref.PAGE, ref.KV_HEADS, ref.HEAD_DIM),
                              devices=[jdev], pool_pages=64)
        with JaxPagedServeEngine(jkv, *jmodel, max_seq_len=ref.MAXLEN,
                                 scheduler=JaxScheduler([jdev]), name="t-example-jax",
                                 **jpol) as eng:
            want = [np.asarray(f.get(timeout=300))
                    for f in [eng.submit(p, max_new_tokens=port.NEW_TOKENS)
                              for p in port.prompts()]]
        assert [list(g) for g in got] == [list(w) for w in want]


def test_torch_examples_import_without_jax():
    code = textwrap.dedent(
        f"""
        import importlib.util, sys
        sys.modules["jax"] = None  # any import of jax now raises
        for name in {sorted(CHECK_LINES)!r}:
            spec = importlib.util.spec_from_file_location(name, "{EXAMPLES}/" + name + ".py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules), "imports repro"
        print("ok")
        """
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_torch_paged_serving_warm_run_with_start_hook_serves_the_same_tokens():
    """``serve(warm=True, on_start=...)``, as the card's smoke measures the
    example: the warm-up request is left out of the metrics, the hook runs
    once before the prompts, and the tokens equal a cold run's and those of
    a model on the plain paged attention."""
    from repro_torch.core import get_all_devices

    ex = _load("torch_paged_serving")
    dev = get_all_devices(1, 0, platform="cpu").get()[0]
    model = ex.make_model(dev.torch_device)
    cold, _ = ex.serve(dev, model, "t-cold", **ex.policies(False))
    calls = []
    warm, m = ex.serve(dev, model, "t-warm", warm=True, on_start=lambda: calls.append(1),
                       **ex.policies(False))
    plain, _ = ex.serve(dev, ex.make_model(dev.torch_device, impl="ref"), "t-plain",
                        **ex.policies(False))
    assert calls == [1] and m["wall_s"] > 0
    assert m["requests_submitted"] == m["requests_completed"] == len(ex.PROMPT_LENS)
    assert [list(t) for t in warm] == [list(t) for t in cold] == [list(t) for t in plain]
