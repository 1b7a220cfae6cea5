"""The slice as a whole: the fig3 / fig4 / fig5 flows that ``chip_smoke.py``
drives on the card run here on the CPU device, at small sizes, through the
port's runtime and its ``create_program_with_file`` kernels, and are held
against the same flows through the JAX package (the reference benchmarks'
drivers, ``benchmarks/fig{3,4,5}_*.py``) on the same numpy inputs."""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.kernels.mandelbrot.ref import mandelbrot_ref as ref_mandelbrot_ref
from repro.kernels.partition_map.ops import partition_map as ref_partition_map
from repro.kernels.stencil.ops import stencil as ref_stencil
from repro_torch.core import get_all_devices
from repro_torch.kernels import launch_counts, reset_launch_counts

ROOT = os.path.join(os.path.dirname(__file__), "..")
KERNEL_DIR = os.path.join(ROOT, "src", "repro_torch", "kernels")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


@pytest.fixture(scope="module")
def ref_device():
    return ref.get_all_devices(1, 0).get()[0]


def _program(device, name):
    return device.create_program_with_file(os.path.join(KERNEL_DIR, name, "ops.py")).get()


def test_torch_fig3_flow_matches_reference(smoke, device, ref_device):
    rng = np.random.default_rng(3)
    hosts = [rng.standard_normal(4096, dtype=np.float32) for _ in range(4)]
    reset_launch_counts()
    got = smoke.fig3_flow(device, _program(device, "stencil"), hosts)
    assert launch_counts()["stencil"] == 0  # CPU tensors take the plain version

    # the reference benchmark's futurized driver (fig3_stencil.py)
    prog = ref_device.create_program({"stencil": lambda x: ref_stencil(x, impl="ref")}, "fig3").get()
    bufs = [ref_device.create_buffer_from(h) for h in hosts]
    outs = [b.then(lambda buf: prog.run([buf], "stencil", out=[buf], sync="dispatch").get())
            for b in bufs]
    want = [o.then(lambda bl: bl[0].enqueue_read().get()).get() for o in outs]
    for g, w, h in zip(got, want, hosts):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, smoke.host_stencil(h), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_streams", [1, 4])
def test_torch_fig4_flow_matches_reference(smoke, device, ref_device, n_streams):
    parts, part = 4, 2048
    rng = np.random.default_rng(4)
    hosts = [(rng.normal(size=(part,)) * 10).astype(np.float32) for _ in range(parts)]
    ins = [device.create_buffer(part, np.float32).get() for _ in range(parts)]
    outs = [device.create_buffer(part, np.float32).get() for _ in range(parts)]
    streams = [device.create_stream() for _ in range(n_streams)]
    got, events = smoke.fig4_flow(device, _program(device, "partition_map"),
                                  [torch.from_numpy(h) for h in hosts], ins, outs, streams)
    assert len(events) == parts and all(e.query() for ev in events for e in ev)

    prog = ref_device.create_program({"k": lambda x: ref_partition_map(x, impl="ref")}, "fig4").get()
    for g, h in zip(got, hosts):
        b = ref_device.create_buffer_from(h).get()
        w = prog.run([b], "k", out=[b]).get()[0].enqueue_read_sync()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, 1.0, rtol=1e-5)


def test_torch_fig5_flow_matches_reference(smoke, device, ref_device, tmp_path):
    h = w = 64
    size_buf = device.create_buffer_from(np.array([h, w], np.int32)).get()
    imgs = [device.create_buffer((h, w), np.int32).get() for _ in range(2)]
    got = smoke.fig5_flow(device, _program(device, "mandelbrot"), size_buf, imgs, str(tmp_path))
    np.testing.assert_array_equal(np.load(tmp_path / "img1.npy"), got[1])

    # fig5_mandelbrot.py's own image: the jitted jnp oracle at 64 iterations.
    # (At 64 iterations the Pallas kernel and that oracle already differ in
    # 2 pixels of 64 x 64; the port equals the oracle there, bit for bit.)
    want = np.asarray(jax.jit(lambda: ref_mandelbrot_ref(h, w, 64))())
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_torch_smoke_bound_picks_the_larger_time(smoke):
    t, by = smoke.bound(3.35e9, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = smoke.bound(1.0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)


def test_torch_smoke_flash_bound_counts_f32_as_3xtf32(smoke):
    """At the serve shape (B 4, S 2000, H = K = 16, D 128, causal) f32 is
    bounded by 3 tf32 products per f32 one at 495 TFLOP/s, 0.397 ms, not by
    the CUDA cores' 0.979 ms; bf16 by the 989 TFLOP/s tensor cores."""
    flops = 4 * 128 * smoke.attention_pairs(4, 16, 2000, 2000, True)
    assert flops == 65_568_768_000
    t, by, peak = smoke.flash_bound(4 * 2 * 2 * 16_384_000, flops, torch.float32)
    assert by == "operations" and "3xTF32" in peak
    assert t == pytest.approx(3 * flops / 495e12 * 1e3) and 0.397 < t < 0.3975
    t, by, _ = smoke.flash_bound(2 * 2 * 2 * 16_384_000, flops, torch.bfloat16)
    assert by == "operations" and t == pytest.approx(flops / 989e12 * 1e3)
    t, by, _ = smoke.flash_bound(3.35e9, 1.0, torch.float32)
    assert by == "bytes" and t == pytest.approx(1.0)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19flash_fwdIfLi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19flash_fwdIfLi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 193 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19flash_fwdI13__nv_bfloat16Li128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19flash_fwdI13__nv_bfloat16Li128EEEvNS_6ParamsE
    64 bytes stack frame, 56 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 64 bytes cumulative stack size
"""


def test_torch_smoke_reads_registers_and_spills_from_the_build_log(smoke, monkeypatch, tmp_path):
    assert smoke.ptxas_usage(PTXAS_LOG, "flash_fwdIfLi128E") == {
        "registers": 193, "spill_stores": 0, "spill_loads": 0}
    assert smoke.ptxas_usage(PTXAS_LOG, "flash_fwdI13__nv_bfloat16Li128E") == {
        "registers": 128, "spill_stores": 56, "spill_loads": 52}
    assert smoke.ptxas_usage(PTXAS_LOG, "flash_fwdIfLi64E") is None
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    log = smoke._build._target("flash_attention").with_suffix(".log")
    log.write_text(PTXAS_LOG.split("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19"
                                   "flash_fwdI13")[0])
    assert smoke.flash_ptxas(torch.float32, 128)["registers"] == 193
    with pytest.raises(smoke.SmokeFailure, match="no ptxas line"):
        smoke.flash_ptxas(torch.float32, 64)
    log.write_text(PTXAS_LOG)  # one instantiation spills: the check fails
    with pytest.raises(smoke.SmokeFailure, match="spills"):
        smoke.flash_ptxas(torch.float32, 128)


# The ssd_scan part of a real build log (nvcc 12.8, sm_90a).
SSD_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17717ssd_chunk_outputsILi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17717ssd_chunk_outputsILi1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers
ptxas info    : Compile time = 132.688 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17717ssd_chunk_outputsILi2EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17717ssd_chunk_outputsILi2EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 123 registers, used 1 barriers
ptxas info    : Compile time = 166.003 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17714ssd_state_passENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17714ssd_state_passENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers
ptxas info    : Compile time = 83.225 ms
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17716ssd_chunk_statesENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_2dfcb17716ssd_chunk_statesENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compile time = 268.440 ms
"""


def test_torch_smoke_reads_the_three_ssd_kernels_from_the_build_log(smoke, monkeypatch,
                                                                    tmp_path):
    """Each of the three ssd kernels, by name and instantiation; a spill in
    any of them fails the check, and so does a kernel with no line."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    log = smoke._build._target("ssd_scan").with_suffix(".log")
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text(SSD_PTXAS_LOG)
    assert smoke.ssd_ptxas() == {
        "ssd_chunk_outputs<1>": {"registers": 79, "spill_stores": 0, "spill_loads": 0},
        "ssd_chunk_outputs<2>": {"registers": 123, "spill_stores": 0, "spill_loads": 0},
        "ssd_state_pass": {"registers": 128, "spill_stores": 0, "spill_loads": 0},
        "ssd_chunk_states": {"registers": 127, "spill_stores": 0, "spill_loads": 0}}
    entries = SSD_PTXAS_LOG.split("ptxas info    : Compiling")
    spilled = entries[:2] + [entries[2].replace("0 bytes spill stores, 0 bytes spill loads",
                                                "8 bytes spill stores, 8 bytes spill loads")]
    log.write_text("ptxas info    : Compiling".join(spilled + entries[3:]))
    with pytest.raises(smoke.SmokeFailure, match="spills"):
        smoke.ssd_ptxas()
    got = smoke.ssd_ptxas(required=False)
    assert got["ssd_chunk_outputs<2>"] == {"registers": 123, "spill_stores": 8, "spill_loads": 8}
    log.write_text("ptxas info    : Compiling".join(entries[:4]))  # no ssd_chunk_states
    with pytest.raises(smoke.SmokeFailure, match="no ptxas line"):
        smoke.ssd_ptxas()
    # a log given as text is read the same way
    assert smoke.ssd_ptxas(SSD_PTXAS_LOG)["ssd_chunk_states"]["registers"] == 127


def test_torch_smoke_ssd_bound_takes_the_faster_f32_route(smoke):
    """At the serve shape (Bz 4, S 4000, H 24, P 64, N 128) 3xTF32 at
    165 TFLOP/s on the chunked count at chunk 16 (13.84 GFLOP, 0.0839 ms)
    beats the CUDA cores at 67 TFLOP/s on the count at chunk 1 (12.73
    GFLOP, 0.190 ms); a tiny head with a long sequence is bound by bytes."""
    nbytes = 217_673_824
    t, by, peak, flops = smoke.ssd_bound(nbytes, 4, 24, 4000, 64, 128)
    assert flops == smoke.ssd_flops(4, 24, 4000, 64, 128, 16) == 13_836_288_000
    assert by == "operations" and "3xTF32" in peak
    assert t == pytest.approx(3 * flops / 495e12 * 1e3) and 0.0838 < t < 0.0839
    assert smoke.ssd_least_flops(4, 24, 4000, 64, 128) / 67e12 * 1e3 > t
    t, by, _, _ = smoke.ssd_bound(3.35e9, 1, 1, 16, 1, 1)
    assert by == "bytes" and t == pytest.approx(1.0)
    # the chunk-16 count is the least of the chunks the tensor cores take
    assert all(smoke.ssd_flops(4, 24, 4000, 64, 128, l) >= flops for l in (16, 17, 32, 64, 128))


def test_torch_smoke_mandelbrot_flops_count_this_images_work(smoke):
    # two live pixels (64 iterations each), two escaped after 1 and 2:
    # 8 flops per iteration, 3 per escape test, 2 per row and per column
    counts = torch.tensor([[64, 1], [2, 64]], dtype=torch.int32)
    assert smoke.mandelbrot_flops(counts, 64) == 8 * 131 + 3 * 2 + 2 * (2 + 2)


# One paged_attention entry of a real build log (nvcc 12, sm_90a), for
# the dtype ("f" or "13__nv_bfloat16"), load width and chunks a lane.
PAGED_PTXAS_ENTRY = (
    "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_"
    "104c41dd12paged_decodeI{t}Li{w}ELi{n}EEEvNS_6ParamsE' for 'sm_90a'\n"
    "    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads\n"
    "ptxas info    : Used {r} registers, used 1 barriers, 16512 bytes smem\n")
PAGED_INSTANCES = [(t, w, n) for t in ("13__nv_bfloat16", "f")
                   for w, n in ((1, 8), (1, 4), (1, 2), (1, 1), (4, 2), (4, 1))]


def _paged_log(spill_at=None, drop=0):
    return "".join(PAGED_PTXAS_ENTRY.format(t=t, w=w, n=n, r=60 + i, s=8 if i == spill_at else 0)
                   for i, (t, w, n) in enumerate(PAGED_INSTANCES[drop:]))


def test_torch_smoke_reads_every_paged_instantiation_from_the_build_log(smoke):
    """Each of the 12 paged_attention instantiations by dtype, load width
    and chunks a lane; a spill in any of them, or a missing one, fails."""
    got = smoke.paged_ptxas(_paged_log())
    assert len(got) == 12
    assert got["f32 W4 NPL1"] == {"registers": 71, "spill_stores": 0, "spill_loads": 0}
    assert got["bf16 W1 NPL8"]["registers"] == 60
    with pytest.raises(smoke.SmokeFailure, match="spills"):
        smoke.paged_ptxas(_paged_log(spill_at=3))
    with pytest.raises(smoke.SmokeFailure, match="instantiations"):
        smoke.paged_ptxas(_paged_log(drop=1))


def test_torch_smoke_paged_bytes_count_each_kv_row_once_per_kv_head(smoke, device):
    """The bound's bytes at the serve shape: the K and V rows of 12,000
    valid tokens for 16 kv heads of D 128 in f32, q and o, 752 table
    entries and 8 lengths; GQA heads share their kv head's rows."""
    lengths = [1000] * 4 + [2000] * 4
    q, kp, vp, tbl, lens = smoke.paged_inputs(8, 16, 16, 128, 16, 128, lengths, device.torch_device)
    assert smoke.paged_bytes(q, kp, tbl, lens) == 196_742_112
    assert smoke.paged_flops(q, lens, 128 * 16) == 4 * 128 * 16 * 12_000
    g = smoke.paged_inputs(4, 36, 4, 128, 16, 128, [1000, 2000] * 2, device.torch_device,
                           torch.bfloat16)
    assert smoke.paged_bytes(g[0], g[1], g[3], g[4]) == (2 * 6000 * 4 * 128 * 2 + 2 * 4 * 36 * 128 * 2
                                                         + 4 * 376 + 4 * 4)
