"""The op-table analyzer (``repro_torch.analysis.op_analysis``) against the
JAX package's HLO analyzer (``repro.analysis.hlo_analysis``) on the same
programs: FLOPs of a matmul loop exactly (a 16-step loop against the
reference's hand-written scan fixture) and within 1% of the reference's
analysis of the JAX-compiled scan; collective wire bytes and counts under
a 4-rank fake world against the reference's collective fixture, with a
reduce-scatter and an all-to-all against hand counts; an in-place slice
update charged at twice the update, as the reference charges a
dynamic-update-slice; the peak of live storage against a hand count; a
``DTensor`` matmul counted once, at the local shard's shape."""
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro.analysis.hlo_analysis import analyze as jax_analyze
from repro_torch.analysis.op_analysis import Recorder, analyze, record, tensor_bytes
from repro_torch.core.executor import reset_runtime
from repro_torch.launch.mesh import fake_world, make_host_mesh

# the reference's hand-written 16-step scan of tanh(c @ w) at 256 x 256
# (tests/test_hlo_analysis.py's SIMPLE)
from test_hlo_analysis import SIMPLE

# the reference's collective fixture (tests/test_hlo_analysis.py)
COLLECTIVES_HLO = textwrap.dedent(
    """\
    HloModule jit_g, is_scheduled=true

    ENTRY %main (x: f32[1024]) -> f32[1024] {
      %x = f32[1024]{0} parameter(0)
      %all-reduce.1 = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
      %all-gather.1 = f32[4096]{0} all-gather(%all-reduce.1), replica_groups=[1,4]<=[4], dimensions={0}
      ROOT %slice = f32[1024]{0} slice(%all-gather.1), slice={[0:1024]}
    }
    """
)

# the reference's in-place dynamic-update-slice fixture: a (1, 1024) f32
# row written into a (64, 1024) buffer
DUS_HLO = textwrap.dedent(
    """\
    HloModule jit_h, is_scheduled=true

    %fused_computation (param_0: f32[64,1024], param_1: f32[1,1024], param_2: s32[]) -> f32[64,1024] {
      %param_0 = f32[64,1024]{1,0} parameter(0)
      %param_1 = f32[1,1024]{1,0} parameter(1)
      %param_2 = s32[] parameter(2)
      %c0 = s32[] constant(0)
      ROOT %dynamic-update-slice.1 = f32[64,1024]{1,0} dynamic-update-slice(%param_0, %param_1, %param_2, %c0)
    }

    ENTRY %main (buf: f32[64,1024], upd: f32[1,1024], i: s32[]) -> f32[64,1024] {
      %buf = f32[64,1024]{1,0} parameter(0)
      %upd = f32[1,1024]{1,0} parameter(1)
      %i = s32[] parameter(2)
      ROOT %dus_fusion = f32[64,1024]{1,0} fusion(%buf, %upd, %i), kind=kLoop, calls=%fused_computation
    }
    """
)


def _tanh_loop(x, w, n):
    c = x
    for _ in range(n):
        c = torch.tanh(c @ w)
    return c


def test_loop_flops_equal_reference_fixture():
    x, w = torch.randn(256, 256), torch.randn(256, 256)
    table = record(_tanh_loop, x, w, 16)
    out = analyze(table)
    assert out["flops"] == jax_analyze(SIMPLE)["flops"] == 16 * 2 * 256 ** 3
    assert out["num_computations"] == 32  # 16 matmuls, 16 tanh
    assert out["collective_counts"] == {} and out["collective_wire_bytes"] == 0.0


def test_loop_flops_match_jax_compiled_scan():
    import jax
    import jax.numpy as jnp

    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None

        y, _ = jax.lax.scan(body, x, None, length=8)
        return y

    spec = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    ref = jax_analyze(jax.jit(f).lower(spec, spec).compile().as_text())
    out = analyze(record(_tanh_loop, torch.randn(128, 128), torch.randn(128, 128), 8))
    assert out["flops"] == pytest.approx(ref["flops"], rel=0.01)


def test_rows_are_json_and_analysis_is_pure():
    import json

    table = record(_tanh_loop, torch.randn(8, 8), torch.randn(8, 8), 2)
    again = json.loads(json.dumps(table))
    assert analyze(again, detail=True) == analyze(table, detail=True)
    assert table[0]["op"] == "aten.mm.default"
    assert table[0]["out"] == [{"t": "f32", "s": [8, 8]}]
    # mm reads two 8x8 f32 and writes one; tanh reads one and writes one
    assert analyze(table)["hbm_bytes"] == 2 * (3 + 2) * 8 * 8 * 4


def _collectives(kinds):
    import torch.distributed._functional_collectives as funcol

    g = dist.group.WORLD
    x = torch.ones(1024)
    if "all-reduce" in kinds:
        funcol.all_reduce(x, "sum", g).wait()
    if "all-gather" in kinds:
        funcol.all_gather_tensor(x, 0, g).wait()
    if "reduce-scatter" in kinds:
        funcol.reduce_scatter_tensor(x, "sum", 0, g).wait()
    if "all-to-all" in kinds:
        funcol.all_to_all_single(x, None, None, g).wait()


def test_collectives_match_reference_fixture():
    ref = jax_analyze(COLLECTIVES_HLO)
    with fake_world(4, device_type="cpu"):
        out = analyze(record(_collectives, ("all-reduce", "all-gather")))
    assert out["collective_counts"] == ref["collective_counts"] == {"all-reduce": 1,
                                                                    "all-gather": 1}
    assert out["collective_wire_bytes"] == pytest.approx(ref["collective_wire_bytes"])
    assert out["collective_by_kind"] == pytest.approx(ref["collective_by_kind"])


def test_reduce_scatter_and_all_to_all_hand_counts():
    with fake_world(4, device_type="cpu"):
        table = record(_collectives, ("reduce-scatter", "all-to-all"))
    out = analyze(table)
    b = 1024 * 4
    # reduce-scatter: result b/4 a rank, b (n-1)/n on the wire; all-to-all: b (n-1)/n
    assert out["collective_by_kind"] == pytest.approx({"reduce-scatter": b * 3 / 4,
                                                       "all-to-all": b * 3 / 4})
    assert out["collective_counts"] == {"reduce-scatter": 1, "all-to-all": 1}
    assert all(r["n"] == 4 for r in table if "coll" in r)
    assert not any("wait_tensor" in r["op"] for r in table)


def test_inplace_slice_update_charged_twice_the_update():
    buf, upd = torch.zeros(64, 1024), torch.ones(1, 1024)

    def write_row(buf, upd, i):
        buf[i:i + 1] = upd

    out = analyze(record(write_row, buf, upd, 3))
    assert out["hbm_bytes"] == jax_analyze(DUS_HLO)["hbm_bytes"] == 2 * 1024 * 4

    def index_copy(buf, upd):
        buf.index_copy_(0, torch.tensor([5]), upd)

    table = record(index_copy, buf, upd)
    row = next(r for r in table if r["op"] == "aten.index_copy_.default")
    assert analyze([row])["hbm_bytes"] == 2 * 1024 * 4


def test_peak_temp_bytes_hand_count():
    def three_ops(x):
        a = x * 2  # live: a (4 KiB)
        b = torch.cat([a, a])  # live: a + b (12 KiB)
        del a
        return b.sum()  # live: b + the sum (8 KiB + 4 B)

    x = torch.ones(1024)
    with Recorder() as rec:
        three_ops(x)
    assert rec.peak_bytes == 1024 * 4 + 2 * 1024 * 4
    assert [r["op"] for r in rec.table] == ["aten.mul.Tensor", "aten.cat.default",
                                           "aten.sum.default"]


def test_views_cost_nothing_and_are_not_allocations():
    def f(x):
        y = x.reshape(-1)[:10].unsqueeze(0).expand(3, 10)
        return x.t()[1], y.permute(1, 0)

    x = torch.ones(32, 32)
    with Recorder() as rec:
        f(x)
    assert rec.table and all(r.get("view") for r in rec.table)
    assert analyze(rec.table)["hbm_bytes"] == 0.0
    assert rec.peak_bytes == 0


def test_dtensor_matmul_counted_once_at_local_shape():
    """The probe that motivated the design: a FlopCounterMode counts a
    sharded DTensor matmul at both levels; the op table has it once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(4, device_type="cpu"):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(4096, 2048), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(2048, 8192), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            with Recorder() as rec:
                y = a @ w
                y.redistribute(mesh, [Replicate(), Replicate()])
    mms = [r for r in rec.table if r["op"] == "aten.mm.default"]
    assert [m["args"][0]["s"] for m in mms] == [[2048, 2048]]
    out = analyze(rec.table)
    assert out["flops"] == 2 * 2048 * 2048 * 4096
    # the replicate: an all-gather over each mesh dim of 2 ranks
    assert out["collective_counts"] == {"all-gather": 2}
    assert all(r["n"] == 2 for r in rec.table if "coll" in r)


def test_fake_world_is_torn_down_and_refuses_a_second_group():
    with fake_world(4, device_type="cpu"):
        assert dist.get_world_size() == 4
        with pytest.raises(ValueError, match="already up"):
            with fake_world(8, device_type="cpu"):
                pass
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(1, 1, device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        reset_runtime()
    assert not dist.is_initialized()


def test_tensor_bytes_uses_the_reference_dtype_table():
    assert tensor_bytes({"t": "bf16", "s": [8]}) == 16
    assert tensor_bytes({"t": "pred", "s": []}) == 1
    assert tensor_bytes({"t": "f32", "s": [256, 256]}) == 256 * 256 * 4
