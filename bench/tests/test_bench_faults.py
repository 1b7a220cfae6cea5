"""A run with its timed path broken underneath comes out not correct: a
sound run first, then each fault the cells can have, planted in the port
(the look for a chip skipped, everything else the run does).  Serving: a
token altered where it is sampled; a decode step that leaves its state
(the KV pages) unchanged.  Training: a step that returns its state
unchanged; half the batch left out, the mean taken over the rest."""
import numpy as np
import pytest

from bench_tiny import make_root, run_cell
from benchlib import port

port.import_port()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["olmo-tiny.chat-tiny", "hymba-tiny.chat-tiny"])
def test_bench_sound_serving_run_is_correct(root, cell):
    rc, res, err = run_cell(root, cell, seed=2**31 + 7)
    assert rc == 0 and res["correct"], err[-3000:]
    assert res["checks"]["max_logit_gap"]["value"] <= res["checks"]["max_logit_gap"]["limit"]


def test_bench_altered_token_is_not_correct(root, monkeypatch):
    from repro_torch.serving import paged

    real = paged.sample_token

    def altered(logits, params, request_id, position):
        tok = real(logits, params, request_id, position)
        return (tok + 1) % np.asarray(logits).reshape(-1).size if position == 2 else tok

    monkeypatch.setattr(paged, "sample_token", altered)
    rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", seed=2**31 + 8)
    assert rc == 0 and res["correct"] is False


def test_bench_decode_step_leaving_its_state_is_not_correct(root, monkeypatch):
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "page_scatter", lambda kp, vp, k, v, tables, positions: (kp, vp))
    rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", seed=2**31 + 9)
    assert rc == 0 and res["correct"] is False


def test_bench_sound_training_run_is_correct(root):
    rc, res, err = run_cell(root, "olmo-tiny.train-tiny", seed=2**31 + 10)
    assert rc == 0 and res["correct"], err[-3000:]


def _broken_step(monkeypatch, breaker):
    from repro_torch.training import train_step

    real = train_step.make_train_step

    def make(*a, **kw):
        return breaker(real(*a, **kw))

    monkeypatch.setattr(train_step, "make_train_step", make)


def test_bench_step_returning_its_state_unchanged_is_not_correct(root, monkeypatch):
    def breaker(step):
        def same(params, state, batch):
            _, _, m = step(_copy(params), _copy(state), batch)
            return params, state, m
        return same

    _broken_step(monkeypatch, breaker)
    rc, res, err = run_cell(root, "olmo-tiny.train-tiny", seed=2**31 + 11)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_bench_half_the_batch_is_not_correct(root, monkeypatch):
    def breaker(step):
        def half(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})
        return half

    _broken_step(monkeypatch, breaker)
    rc, res, err = run_cell(root, "olmo-tiny.train-tiny", seed=2**31 + 12)
    assert rc == 0 and res["correct"] is False


def _copy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_bench_training_control_is_not_correct(root):
    """With ``--control 1`` the reference in fp8 products, in the program's
    place, is judged by the cell's limits and comes out not correct (at the
    tiny size, on the CPU), where the program comes out correct."""
    rc, res, err = run_cell(root, "olmo-tiny.train-tiny", seed=2**31 + 13, control=1)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert res["control_correct"] is False, err[-3000:]
    assert "control_correct: False" in err
