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


def test_torch_smoke_mandelbrot_unfused_bound_takes_one_slot_a_flop(smoke):
    """fig5's image (4096^2, 64 iterations) needs 2,021,463,495 flops.  At
    67 TFLOP/s, which counts an FMA as two, that is 0.030171 ms; with every
    operation rounded on its own each takes one of 132 x 128 FP32 lanes'
    slots a cycle at 1.98 GHz: 0.060425 ms."""
    flops = 2_021_463_495
    assert smoke.F32_SLOTS_PER_S == 132 * 128 * 1.98e9
    assert smoke.bound(4 * 4096 * 4096, flops) == (pytest.approx(0.030171, abs=1e-6), "operations")
    assert flops / smoke.F32_SLOTS_PER_S * 1e3 == pytest.approx(0.060425, abs=1e-6)


def _ids(shape, rule) -> "torch.Tensor":
    rows, cols = torch.meshgrid(torch.arange(shape[0]), torch.arange(shape[1]), indexing="ij")
    return rule(rows, cols).to(torch.int64)


@pytest.mark.parametrize("rule,slow,want", [
    # 8 x 4 pixel tiles a warp: one tile holds both slow pixels
    (lambda r, c: r // 4 * 4 + c // 8, [(0, 0), (1, 0)], 272 / (32 * 16)),
    # 32 pixels of a row a warp: the slow pixels are in two warps
    (lambda r, c: r, [(0, 0), (1, 0)], 272 / (32 * 24)),
    # a round of one pixel: one lane of 32 works
    (lambda r, c: r * 32 + c, [(0, 0)], 1 / 32),
])
def test_torch_smoke_mandelbrot_simt_counts_each_warps_slowest_lane(smoke, rule, slow, want):
    counts = torch.ones((8, 32), dtype=torch.int32)
    for r, c in slow:
        counts[r, c] = 9
    assert smoke.mandelbrot_simt(counts, _ids((8, 32), rule)) == pytest.approx(want)


@pytest.mark.parametrize("shape,block,grid,rule", [
    # 32 threads a warp, in order along the block's rows
    ((8, 32), (32, 8), (1, 1), lambda r, c: r << 32),
    ((8, 32), (16, 2), (2, 4), lambda r, c: ((r // 2 % 4) * 2 + c // 16) << 32),
    # rows 8-15 are the block's second pass of the grid-stride loop
    ((16, 32), (32, 8), (1, 1), lambda r, c: r % 8 << 32 | r // 8),
    # one thread: each pixel is a pass of its own
    ((4, 4), (1, 1), (1, 1), lambda r, c: r * 4 + c),
])
def test_torch_profile_tool_models_row_order_rounds(profile_tool, shape, block, grid, rule):
    got = profile_tool.row_order_rounds(*shape, grid, block)
    assert torch.equal(got, _ids(shape, rule))


# A real build log of csrc/mandelbrot.cu (nvcc 12.8, sm_90a).
MANDEL_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__f80b0f0f_13_mandelbrot_cu_611324e917mandelbrot_kernelEPiiiiffff' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__f80b0f0f_13_mandelbrot_cu_611324e917mandelbrot_kernelEPiiiiffff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compile time = 22.945 ms
"""


def test_torch_smoke_reads_the_mandelbrot_kernel_from_the_build_log(smoke):
    assert smoke.mandelbrot_ptxas(MANDEL_PTXAS_LOG) == {
        "registers": 30, "spill_stores": 0, "spill_loads": 0}
    with pytest.raises(smoke.SmokeFailure, match="spills"):
        smoke.mandelbrot_ptxas(MANDEL_PTXAS_LOG.replace("0 bytes spill stores", "8 bytes spill stores"))
    with pytest.raises(smoke.SmokeFailure, match="no ptxas line"):
        smoke.mandelbrot_ptxas("ptxas info    : 0 bytes gmem\n")


# The pixel loop of a real SASS dump (cuobjdump -sass, nvcc 12.8, sm_90a)
# of an earlier csrc/mandelbrot.cu: one thread a pixel, the escape test
# and a branch in every step.  Trailing encodings dropped.
PIXEL_LOOP_SASS = """\
        /*0690*/                   LDC R5, c[0x0][0x21c] ;
        /*06a0*/                   BSSY B0, 0x990 ;
        /*06b0*/                   ISETP.GE.AND P0, PT, R2, R5, PT ;
        /*06c0*/               @P0 BRA 0x980 ;
        /*06d0*/                   SHF.R.S32.HI R4, RZ, 0x1f, R9 ;
        /*06e0*/                   ULDC UR8, c[0x0][0x230] ;
        /*06f0*/                   I2FP.F32.S32 R0, R9 ;
        /*0700*/                   IMAD.MOV.U32 R8, RZ, RZ, R2 ;
        /*0710*/                   IMAD R6, R4, R5.reuse, RZ ;
        /*0720*/                   IMAD.WIDE.U32 R4, R9, R5, RZ ;
        /*0730*/                   FMUL R0, R0, UR8 ;
        /*0740*/                   ULDC UR8, c[0x0][0x228] ;
        /*0750*/                   IMAD R7, R9, UR5, R6 ;
        /*0760*/                   FADD R17, R0, UR8 ;
        /*0770*/                   IADD3 R15, R5, R7, RZ ;
        /*0780*/                   I2FP.F32.S32 R0, R8 ;
        /*0790*/                   ULDC UR8, c[0x0][0x22c] ;
        /*07a0*/                   ULDC UR9, c[0x0][0x224] ;
        /*07b0*/                   BSSY B1, 0x8e0 ;
        /*07c0*/                   CS2R R6, SRZ ;
        /*07d0*/                   FMUL R0, R0, UR8 ;
        /*07e0*/                   IMAD.MOV.U32 R13, RZ, RZ, RZ ;
        /*07f0*/                   FADD R19, R0, UR9 ;
        /*0800*/                   FMUL R0, R6, R6 ;
        /*0810*/                   FMUL R21, R7, R7 ;
        /*0820*/                   FADD R10, R0, R21 ;
        /*0830*/                   FSETP.GTU.AND P0, PT, R10, 4, PT ;
        /*0840*/               @P0 BRA 0x8d0 ;
        /*0850*/                   VIADD R13, R13, 0x1 ;
        /*0860*/                   FMUL R7, R7, 2 ;
        /*0870*/                   FADD R0, -R0, R21 ;
        /*0880*/                   ISETP.GE.AND P0, PT, R13, UR10, PT ;
        /*0890*/                   FMUL R6, R7, R6 ;
        /*08a0*/                   FADD R7, R19, R0 ;
        /*08b0*/                   FADD R6, R17, R6 ;
        /*08c0*/              @!P0 BRA 0x800 ;
        /*08d0*/                   BSYNC B1 ;
        /*08e0*/                   IADD3 R0, P0, R8, R4, RZ ;
        /*08f0*/                   ULDC.64 UR8, c[0x0][0x210] ;
        /*0900*/                   LEA.HI.X.SX32 R7, R8, R15, 0x1, P0 ;
        /*0910*/                   LEA R6, P0, R0.reuse, UR8, 0x2 ;
        /*0920*/                   ULDC UR8, c[0x0][0x21c] ;
        /*0930*/                   IADD3 R8, R11, R8, RZ ;
        /*0940*/                   LEA.HI.X R7, R0, UR9, R7, 0x2, P0 ;
        /*0950*/                   ISETP.GE.AND P0, PT, R8, UR8, PT ;
        /*0960*/                   STG.E desc[UR6][R6.64], R13 ;
        /*0970*/              @!P0 BRA 0x780 ;
        /*0980*/                   BSYNC B0 ;
        /*0990*/                   VIADD R9, R9, UR4 ;
        /*09a0*/                   ULDC UR8, c[0x0][0x218] ;
        /*09b0*/                   ISETP.GE.AND P0, PT, R9, UR8, PT ;
        /*09c0*/              @!P0 BRA 0x690 ;
"""


def test_torch_smoke_reads_opcodes_from_the_sass(smoke):
    ins = smoke.sass_instructions(PIXEL_LOOP_SASS)
    assert len(ins) == 52 and ins[0] == (0x690, "LDC", "R5, c[0x0][0x21c]")
    assert ins[3] == (0x6c0, "BRA", "0x980")  # the predicate is dropped
    assert smoke.sass_count(PIXEL_LOOP_SASS, "FMUL") == 6
    assert smoke.sass_count(PIXEL_LOOP_SASS, "FADD") == 6
    assert smoke.sass_count(PIXEL_LOOP_SASS, "FFMA") == 0
    fused = PIXEL_LOOP_SASS.replace("FMUL R6, R7, R6", "FFMA R6, R7, R6, R17")
    assert smoke.sass_count(fused, "FFMA") == 1


@pytest.fixture(scope="module")
def profile_tool():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_mandelbrot", os.path.join(ROOT, "tools", "profile_torch_mandelbrot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sass(lines: "list[str]") -> str:
    """Instructions in cuobjdump's layout, 16 bytes apart from 0."""
    return "".join(f"        /*{16 * i:04x}*/                   {ln} ;\n"
                   for i, ln in enumerate(lines))


STEP = ["FMUL R1, R2, R2", "FMUL R3, R4, R4", "FADD R5, R1, R3", "FMUL R6, R2, 2",
        "FMUL R6, R6, R4", "FADD R4, R6, R7", "FADD R1, R1, -R3", "FADD R2, R1, R8"]


def test_torch_profile_tool_accounts_the_one_step_loop(profile_tool, smoke):
    """The pixel loop above: 13 instructions a step (8 FP32 operations, the
    test, its branch, the counter, its compare and the loop's branch) and
    19 of the pixel's own outside it."""
    acc = profile_tool.sass_accounting(smoke.sass_instructions(PIXEL_LOOP_SASS))
    assert acc == {"step": 13.0, "block": 13, "block_steps": 1, "warm_up_step": 0.0,
                   "warm_up_tests": 0, "escape": 0, "pixel": 19.0}


def test_torch_profile_tool_accounts_warm_up_blocks_and_escape(profile_tool, smoke):
    """A constructed kernel in the layout of the redesigned one: a pixel
    loop (0x00-0xf0 with the row loop around it) holding a warm-up of two
    tested steps, a loop of two-step blocks and an escape path."""
    lines = (["I2FP.F32.S32 R0, R9", "FMUL R0, R0, UR8", "BSSY B1, 0x{end}"]
             + (STEP + ["FSETP.GTU.AND P0, PT, R5, 4, PT", "@P0 BRA 0x{end}"]) * 2
             + STEP * 2 + ["FSETP.LE.AND P0, PT, R5, 4, PT", "@!P0 BRA 0x{esc}",
                           "IADD3 R13, R13, 0x8, RZ", "ISETP.GT.AND P0, PT, R13, R10, PT",
                           "@!P0 BRA 0x{blk}"]
             + ["SEL R12, R12, 0x1, !P1", "IADD3 R14, R12, R13, RZ", "BSYNC B1",
                "STG.E desc[UR6][R12.64], R14", "@!P0 BRA 0x0", "@!P1 BRA 0x0"])
    blk = 3 + 2 * 10
    esc = blk + 16 + 5
    end = esc + 2
    text = _sass([ln.format(end=f"{16 * end:x}", esc=f"{16 * esc:x}", blk=f"{16 * blk:x}")
                  for ln in lines])
    acc = profile_tool.sass_accounting(smoke.sass_instructions(text))
    # the block: 2 steps of 8, one test (folded), its branch, counter, compare, branch
    assert acc["block"] == 21 and acc["block_steps"] == 2 and acc["step"] == 10.5
    # warm-up: from the first test to the block loop, 2 tests
    assert acc["warm_up_tests"] == 2 and acc["warm_up_step"] == (blk - 11) / 2
    assert acc["escape"] == 2
    # the pixel loop's own: 29 outside the block loop, less the escape and the warm-up's
    assert acc["pixel"] == (len(lines) - 1) - 21 - 2 - acc["warm_up_step"] * 2


def test_torch_profile_tool_takes_one_function_of_the_sass(profile_tool):
    text = ("\t\tFunction : _ZN4anon18warp_rounds_kernelEPxii\n" + _sass(["EXIT"])
            + "\t\tFunction : _ZN4anon17mandelbrot_kernelEPiiiiffff\n" + _sass(STEP + ["EXIT"]))
    part = profile_tool.function_sass(text, "mandelbrot_kernel")
    assert "FMUL R1, R2, R2" in part and "warp_rounds" not in part
    with pytest.raises(RuntimeError, match="0 functions"):
        profile_tool.function_sass(text, "stencil_kernel")


def test_torch_profile_tool_predicts_from_trips_and_pixels(profile_tool):
    acc = {"step": 9.0, "warm_up_step": 11.0, "warm_up_tests": 7, "pixel": 20.0}
    counts = torch.tensor([[64, 3]])
    # warm-up trips min(64, 8) + 3 = 11 at 11 slots, 56 more at 9, 2 pixels at 20
    slots = 11 * 11.0 + 56 * 9.0 + 2 * 20.0
    got = profile_tool.predicted_ms(acc, counts, 8, 0.5, 132, 1980.0)
    assert got == pytest.approx(slots / (0.5 * 128 * 132 * 1980e6) * 1e3)
    # no warm-up: every trip at the step's slots
    got = profile_tool.predicted_ms({**acc, "warm_up_tests": 0}, counts, 0, 0.5, 132, 1980.0)
    assert got == pytest.approx((67 * 9.0 + 40.0) / (0.5 * 128 * 132 * 1980e6) * 1e3)


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
