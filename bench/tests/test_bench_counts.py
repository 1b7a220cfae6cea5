"""The benchmark's own counts of a kernel call's work, against shapes
worked by hand, and the roofline arithmetic."""
from types import SimpleNamespace

import pytest

from bench_tiny import HYMBA_1_5B
from benchlib import flops, peaks, readers, registry


def test_bench_counts_paged_attention_by_hand():
    # B 8: four rows of 1000 slots and four of 2000; OLMo-1B's heads, f32, pages of 16
    pa = registry.load_module("counts", "paged_attention")
    f, b = pa.work([1000] * 4 + [2000] * 4, 16, 16, 128, 4, 16)
    assert f == 4 * 16 * 128 * 12000 == 98_304_000
    kv = 4 * 2 * 16 * 128 * 12000          # keys and values covered
    qo = 4 * 2 * 8 * 16 * 128              # q read, output written
    meta = 4 * (8 + 4 * 63 + 4 * 125)      # lengths and the covered pages' table entries
    assert b == kv + qo + meta == 196_742_112


def test_bench_counts_flash_attention_by_hand():
    # B 4, S 2000, H 16 (MHA), D 128, causal, f32
    fa = registry.load_module("counts", "flash_attention")
    f, b = fa.work(4, 2000, 16, 16, 128, 4)
    assert f == 4 * 4 * 16 * 128 * (2000 * 2001 // 2) == 65_568_768_000
    assert b == 4 * (4 * 4 * 2000 * 16 * 128) == 262_144_000
    f2, _ = fa.work(4, 2000, 16, 16, 128, 4, causal=False)
    assert f2 == 4 * 4 * 16 * 128 * 2000 * 2000


@pytest.mark.parametrize("kernel,names", [("flash_attention", ("flash_fwd",)),
                                          ("paged_attention", ("paged_decode",))])
def test_bench_kernel_calls_are_found_by_their_counts_files_names(kernel, names):
    # a kernel's device names live in its counts file; the readers hold none
    assert registry.load_module("counts", kernel).DEVICE_NAMES == names
    ops = [("flash_fwd<128>", 10, 20, 7, 1), ("paged_decode_split", 30, 40, 9, 2),
           ("sgemm", 50, 60, 7, 3), ("flash_fwd<128>", 500, 600, 7, 4)]

    class Trace:
        h0, h1 = 0, 100

        def kernels(self, needle):
            return [o for o in ops if needle in o[0]]

    run = SimpleNamespace(trace=Trace(), module=lambda kind, name: registry.load_module(kind, name))
    got = readers.kernel_ops(run, kernel)
    assert [o[0] for o in got] == [o[0] for o in ops[:2] if any(n in o[0] for n in names)]


def test_bench_paged_layers_a_decode_step():
    a = registry.load_json("configs", "olmo-1b")["arch"]
    assert flops.paged_layers(a) == 16
    assert flops.paged_layers(HYMBA_1_5B["arch"]) == 3  # its windowed layers read a ring


def test_bench_roofline_takes_the_larger_term_and_sums_calls():
    op = ("k", 0, 1_000_000, 7, 1)          # 1 ms
    w = (495e12 * 1e-4, 3.35e12 * 2e-4)     # 0.1 ms of f32 operations, 0.2 ms of bytes
    assert readers.roofline([(op, w)], "float32") == pytest.approx(20.0)
    assert readers.roofline([(op, w), (op, None)], "float32") == pytest.approx(10.0)
    assert peaks.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert readers.roofline([], "float32") is None


def test_bench_flops_olmo_train_step():
    a = registry.load_json("configs", "olmo-1b")["arch"]
    assert flops.matmul_params(a) == 16 * (4 * 2048 * 2048 + 3 * 2048 * 8192)
    f = flops.train_flops(a, 4, 2048)
    mat = 6 * (flops.matmul_params(a) + 2048 * 50304) * 8192
    attn = 3 * 4 * 16 * 4 * 16 * 128 * (2048 * 2049 // 2)
    assert f == mat + attn
    assert 6.0e13 < f < 6.3e13


def test_bench_flops_hybrid_counts_every_layer_and_the_window():
    a = HYMBA_1_5B["arch"]
    # 3 global layers over the whole prefix, 29 windowed ones over at most 1024 keys
    S = 3000
    per = 4 * 25 * 64
    glob = 3 * per * (S * (S + 1) // 2)
    win = 29 * per * (1024 * 1025 // 2 + (S - 1024) * 1024)
    assert flops.attention_flops_prefill(a, S) == glob + win
    d = flops.decode_flops(a, 2000)
    assert d - flops.decode_flops(a, 1999) == 3 * per  # only the global layers grow
