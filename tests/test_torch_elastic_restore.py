"""Elastic restart onto another mesh (``CheckpointManager.restore(
shardings=...)``), as ``tests/test_elastic_restore.py`` holds the JAX
package's: a checkpoint saved under one mesh restores onto a DIFFERENT
mesh shape with the values bit-equal and the leaves on the new mesh's
shape and placements.

Four gloo ranks on the CPU: smoke StableLM-1.6B params placed by
``tree_sharding`` on a (2, 2) ("data", "model") mesh are saved (each
``DTensor`` leaf gathered whole; rank 0 writes), then restored onto (4, 1)
and (1, 4) meshes, and, with no ``shardings``, onto the placements of a
``DTensor`` ``like``.  The file itself holds the full values, as the
reference's ``np.asarray`` of a sharded array writes them.
"""
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro_torch.configs import get_config, smoke
from repro_torch.models import get_model

pytestmark = pytest.mark.slow

_CHILD = """
import os
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import tree_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

cfg = smoke(get_config("stablelm-1.6b"))
m = get_model(cfg)
rules = plan_for(cfg, ShapeConfig("t", 32, 4, "train")).rules
pspecs = m.param_specs(cfg)

def place(mesh, tree):
    flat, tdef = tree_flatten(tree)
    sh = tree_flatten(tree_sharding(mesh, pspecs, rules, tree))[0]
    return tree_unflatten(tdef, [s.distribute(x) for x, s in zip(flat, sh)]), sh

mesh_a = make_host_mesh(2, 2, device_type="cpu")
params = m.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
params_a, _ = place(mesh_a, params)
d = sys.argv[3] + ".ckpt"
mgr = CheckpointManager(d)
mgr.save_async(1, params_a, extra={"step": 1}).get()
dist.barrier()  # rank 0 wrote it
orig = tree_flatten(params)[0]

for shape in ((4, 1), (1, 4)):
    mesh_b = make_host_mesh(*shape, device_type="cpu")
    sh_b = tree_sharding(mesh_b, pspecs, rules, params)
    restored, extra = mgr.restore(tree_map(torch.zeros_like, params), shardings=sh_b)
    leaves = tree_flatten(restored)[0]
    equal = all(torch.equal(a, b.full_tensor()) for a, b in zip(orig, leaves))
    placed = all(isinstance(b, DTensor) and tuple(b.device_mesh.shape) == shape
                 and tuple(b.device_mesh.mesh_dim_names) == ("data", "model")
                 and tuple(b.placements) == s.placements
                 for b, s in zip(leaves, tree_flatten(sh_b)[0]))
    wq = restored["layers"]["attn"]["wq"]
    report({"shape": list(shape), "equal": equal, "placed": placed, "extra": extra,
            "wq": [str(p) for p in wq.placements], "wq_local": list(wq.to_local().shape)})

# no shardings: a DTensor like's own mesh and placements
zeros, _ = place(mesh_a, tree_map(torch.zeros_like, params))
back, _ = mgr.restore(zeros)
leaves = tree_flatten(back)[0]
report({"like_equal": all(torch.equal(a, b.full_tensor()) for a, b in zip(orig, leaves)),
        "like_placed": all(b.placements == z.placements and b.device_mesh is mesh_a
                           for b, z in zip(leaves, tree_flatten(zeros)[0])),
        "dir": d, "files": sorted(os.listdir(d))})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_CHILD, 4, tmp_path_factory.mktemp("elastic_restore"), timeout=300)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_torch_restore_onto_different_mesh(ranks, shape):
    cfg = smoke(get_config("stablelm-1.6b"))
    for rank in ranks:
        r = next(x for x in rank if x.get("shape") == list(shape))
        assert r["equal"] and r["placed"] and r["extra"] == {"step": 1}
    r = next(x for x in ranks[0] if x.get("shape") == list(shape))
    # wq (L, d, H*hd): "p_embed" over data, "p_heads" over model; a mesh
    # dim of one rank replicates
    data, model = shape
    assert r["wq"] == ["S(1)" if data > 1 else "R", "S(2)" if model > 1 else "R"]
    assert r["wq_local"] == [cfg.num_layers, cfg.d_model // data,
                             cfg.num_heads * cfg.hd // model]


def test_torch_restore_onto_a_dtensor_like_and_the_file_is_whole(ranks):
    for rank in ranks:
        assert rank[-1]["like_equal"] and rank[-1]["like_placed"]
    d = ranks[0][-1]["dir"]
    assert ranks[0][-1]["files"] == ["step_00000001"]
    cfg = smoke(get_config("stablelm-1.6b"))
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    with np.load(f"{d}/step_00000001/arrays.npz") as z:
        np.testing.assert_array_equal(z["layers/attn/wq"], params["layers"]["attn"]["wq"].numpy())
        assert z["embed/table"].shape == tuple(params["embed"]["table"].shape)
