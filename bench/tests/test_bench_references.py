"""The plain references against the port at a tiny size on the CPU: the
dense model's logits and loss, the hybrid's logits within the window, and
past the window the port's own decode path (its ring caches), token by
token.  The references import nothing of the program."""
import ast

import pytest
import torch

from bench_tiny import BENCH, HYMBA_1_5B
from benchlib import port, registry

port.import_port()


def _tiny(name, **kw):
    c = HYMBA_1_5B if name == "hymba-1.5b" else registry.load_json("configs", name)
    a = dict(c["arch"])
    a.update(kw)
    return a


DENSE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256)
HYBRID = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              head_dim=16, global_attn_layers=[0, 3], meta_tokens=4)


def test_bench_reference_dense_matches_the_port():
    from repro_torch.models import get_model

    a = _tiny("olmo-1b", **DENSE)
    ref = registry.load_module("reference", "dense")
    params = ref.make_params(a, 11, "cpu")
    cfg = port.arch_config(a)
    m = get_model(cfg)
    tok = torch.randint(0, 256, (2, 24), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lp, _ = m.forward(cfg, params, {"tokens": tok}, impl="ref")
        lr = torch.stack([ref.logits(a, params, tok[i], torch.arange(24)) for i in range(2)])
        assert torch.allclose(lp.float(), lr, atol=2e-5, rtol=0)
        labels = torch.roll(tok, -1, 1)
        lp_loss = m.loss_fn(cfg, params, {"tokens": tok, "labels": labels}, impl="ref")
        assert float(lp_loss) == pytest.approx(float(ref.loss(a, params, tok, labels)), rel=1e-5)


def test_bench_reference_hybrid_within_the_window_matches_the_port():
    from repro_torch.models import get_model

    a = _tiny("hymba-1.5b", sliding_window=64,
              ssm=dict(HYMBA_1_5B["arch"]["ssm"], head_dim=16),
              **HYBRID)
    ref = registry.load_module("reference", "hybrid")
    params = ref.make_params(a, 11, "cpu")
    cfg = port.arch_config(a)
    tok = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lp, _ = get_model(cfg).forward(cfg, params, {"tokens": tok}, impl="ref")
        lr = ref.logits(a, params, tok[0], torch.arange(40))
    assert torch.allclose(lp[0].float(), lr, atol=2e-5, rtol=0)


def test_bench_reference_hybrid_past_the_window_matches_the_port_decode():
    """Past the window the reference holds every key in (q - window, q];
    so does the port's decode through its ring caches."""
    from repro_torch.models import hybrid as H

    a = _tiny("hymba-1.5b", sliding_window=16,
              ssm=dict(HYMBA_1_5B["arch"]["ssm"], head_dim=16),
              **HYBRID)
    ref = registry.load_module("reference", "hybrid")
    params = ref.make_params(a, 12, "cpu")
    cfg = port.arch_config(a)
    tok = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        cache = H.init_cache(cfg, 1, 64, device="cpu", dtype=torch.float32)
        k, v, state, _ = H.paged_prefill(cfg, params, tok[:, :8], impl="ref")  # 4 + 8 <= 16
        H.seed_cache(cfg, cache, k, v, state)
        outs = []
        for t in range(8, 40):
            lg, cache = H.decode_step(cfg, params, cache, tok[:, t:t + 1], t)
            outs.append(lg[0, 0])
        lr = ref.logits(a, params, tok[0], torch.arange(8, 40))
    assert torch.allclose(torch.stack(outs).float(), lr, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["dense", "hybrid"])
def test_bench_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((BENCH / "reference" / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax", "benchlib"}, mods
