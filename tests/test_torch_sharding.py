"""The port's logical-axis sharding rules (``distributed/sharding.py``)
against the JAX package's, on the CPU.

``ShardingCtx.spec`` reads only the mesh's axis sizes, so both packages'
contexts take a mesh given by its sizes (the JAX package's through a
stand-in with ``.shape``), production meshes included: the spec and the
``dropped`` record of every ``ParamDef`` of every registered arch's full
and smoke skeleton must be equal.  The port's DTensor placements, turned
into a ``MeshSharding``, must give every device the block JAX's
``NamedSharding`` gives it (8 host devices, in a subprocess)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.configs as jcfg
import repro.distributed.sharding as jshd
from repro.models import LM as JLM

import repro_torch.configs as tcfg
import repro_torch.distributed.sharding as tshd
from repro_torch.checkpoint.blocks_map import (MeshDevice, MeshSharding,
                                               placement_sharding)
from repro_torch.models import LM
from repro_torch.models.params import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the meshes of the comparison, by their axis sizes in mesh order
MESHES = {"1x1": {"data": 1, "model": 1}, "1x2": {"data": 1, "model": 2},
          "2x1": {"data": 2, "model": 1}, "2x2": {"data": 2, "model": 2},
          "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": (jshd.DEFAULT_RULES, tshd.DEFAULT_RULES),
         "fsdp": (jshd.FSDP_RULES, tshd.FSDP_RULES)}
#: manual axes: none, the data axes (the reduce-once step's), the model
#: axis (the local MoE dispatch's)
MANUAL = {"none": frozenset(), "data": frozenset({"pod", "data"}),
          "model": frozenset({"model"})}


class _Mesh:
    """What the JAX package's ``ShardingCtx.spec`` reads of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _defs(arch: str) -> list:
    out = []
    for get, jget in ((tcfg.get_config, jcfg.get_config),
                      (tcfg.get_smoke_config, jcfg.get_smoke_config)):
        tdefs = tree_leaves(LM(get(arch), device="cpu").skeleton())
        jdefs = [d for d in _jleaves(JLM(jget(arch)).skeleton())]
        assert [(d.shape, d.axes) for d in tdefs] == \
            [(tuple(d.shape), tuple(d.axes)) for d in jdefs]
        out.extend(tdefs)
    return out


def _jleaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jleaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _jleaves(t)]
    return [] if tree is None else [tree]


@pytest.fixture(scope="module")
def all_defs():
    return [d for arch in tcfg.list_archs() for d in _defs(arch)]


@pytest.mark.parametrize("manual", list(MANUAL))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_and_dropped_match_the_reference(all_defs, mesh, rules, manual):
    jrules, trules = RULES[rules]
    sizes = MESHES[mesh]
    jctx = jshd.ShardingCtx(mesh=_Mesh(sizes),
                            rules=jshd.ShardingRules(dict(jrules)),
                            manual=MANUAL[manual])
    tctx = tshd.ShardingCtx(mesh=dict(sizes),
                            rules=tshd.ShardingRules(dict(trules)),
                            manual=MANUAL[manual])
    for d in all_defs:
        for shape in (d.shape, None):
            want = jctx.spec(d.axes, shape)
            got = tctx.spec(d.axes, shape)
            assert tuple(got) == tuple(want), (d, shape)
    assert tctx.dropped == jctx.dropped
    if mesh in ("1x2", "16x16") and manual == "none":
        assert tctx.dropped          # some heads or vocab do not divide


def test_use_sharding_and_shard_without_a_context():
    """``shard`` is a no-op without a context, on a plain tensor under one;
    ``logical_spec`` and ``named_sharding`` follow the reference's."""
    import torch
    x = torch.ones(4, 6)
    assert tshd.shard(x, "batch", None) is x
    assert tshd.current_ctx() is None
    assert tuple(tshd.logical_spec(("batch", "mlp"), (4, 6))) == ()
    assert tshd.named_sharding(("batch",)) is None
    with tshd.use_sharding({"data": 2, "model": 3}) as ctx:
        assert tshd.current_ctx() is ctx
        assert tshd.shard(x, "batch", "mlp") is x
        assert tuple(tshd.logical_spec(("batch", "mlp"), (4, 6))) == \
            ("data", "model")
        sh = tshd.named_sharding(("batch", "mlp"), (4, 6))
        assert isinstance(sh, MeshSharding)
        assert sh.spec == ("data", "model")
        with tshd.use_sharding({"data": 2}, tshd.FSDP_RULES,
                               manual={"data"}) as inner:
            assert tshd.current_ctx() is inner
            assert tuple(tshd.logical_spec(("batch", "embed"), (4, 6))) \
                == ()
        assert tshd.current_ctx() is ctx
    assert tshd.current_ctx() is None
    with pytest.raises(KeyError, match="unknown logical axis"):
        with tshd.use_sharding({"data": 1}):
            tshd.logical_spec(("no_such_axis",), (2,))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    ctx = tshd.ShardingCtx(mesh={"pod": 2, "data": 2, "model": 2},
                           rules=tshd.ShardingRules(dict(tshd.DEFAULT_RULES)))
    assert ctx.placements(("batch", None, "act_heads", None),
                          (8, 3, 4, 5)) == (Shard(0), Shard(0), Shard(2))
    assert ctx.placements(("vocab", "embed"), (7, 4)) == \
        (Replicate(), Replicate(), Replicate())
    # the spec names pod, data major first: DTensor's mesh order
    out_of_order = tshd.ShardingCtx(
        mesh={"data": 2, "pod": 2},
        rules=tshd.ShardingRules(dict(tshd.DEFAULT_RULES)))
    with pytest.raises(ValueError, match="mesh's order"):
        out_of_order.placements(("batch",), (8,))


#: (mesh sizes, logical axes, shape) cases for the devices_indices_map
#: comparison on 8 devices: every rule's axes, a dim over two mesh axes
#: ("batch" over pod and data), dims that do not divide
INDEX_CASES = [
    ({"data": 2, "model": 4}, ("batch", None, "act_heads", None),
     (4, 3, 8, 2)),
    ({"data": 2, "model": 4}, ("layers", "experts", "embed", "expert_mlp"),
     (2, 8, 6, 4)),
    ({"data": 4, "model": 2}, ("vocab", "embed"), (10, 8)),
    ({"data": 1, "model": 8}, ("embed", "heads", "head_dim"), (4, 16, 2)),
    ({"pod": 2, "data": 2, "model": 2}, ("batch", None, "act_mlp"),
     (8, 3, 6)),
    ({"pod": 2, "data": 2, "model": 2}, ("batch", "kv_heads"), (2, 6)),
    ({"pod": 2, "data": 2, "model": 2}, ("layers", "mlp", "embed"),
     (3, 4, 4)),
]

_JAX_INDICES = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
out = []
for sizes, axes, shape in json.loads(sys.argv[1]):
    mesh = make_mesh_compat(tuple(sizes.values()), tuple(sizes))
    with shd.use_sharding(mesh, shd.DEFAULT_RULES) as ctx:
        spec = ctx.spec(axes, shape)
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    ids = np.vectorize(lambda d: d.id)(mesh.devices).tolist()
    out.append({"ids": ids, "map": {str(d.id): [[s.start, s.stop]
                                                for s in idx]
                                    for d, idx in m.items()}})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_indices():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",    # beside the worlds
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _JAX_INDICES,
                        json.dumps(INDEX_CASES)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(INDEX_CASES)))
def test_placements_give_named_sharding_blocks(jax_indices, case):
    sizes, axes, shape = INDEX_CASES[case]
    want = jax_indices[case]
    ctx = tshd.ShardingCtx(mesh=dict(sizes),
                           rules=tshd.ShardingRules(dict(tshd.DEFAULT_RULES)))
    pl = ctx.placements(axes, shape)
    sh = placement_sharding(np.asarray(want["ids"]), tuple(sizes), pl,
                            len(shape))
    got = sh.devices_indices_map(shape)
    assert len(got) == len(want["map"])
    for dev, idx in got.items():
        assert [[s.start, s.stop] for s in idx] == want["map"][str(dev.id)]
    assert MeshDevice(0) in got
