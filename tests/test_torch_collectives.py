"""The port's collectives (``distributed/collectives.py``) and expert
placement (``distributed/expert_placement.py``) against the JAX package's,
on the CPU.

The JAX package runs its collectives inside ``shard_map`` over 2 host
devices (a subprocess with ``XLA_FLAGS``); the port runs them in a 2-rank
gloo world (spawned processes), each rank on its own slice of the same
seeded inputs.  Quantization and the int8 sums are exact: every output,
the error feedback too, must be bit-equal.  The placement planner is a
numpy copy: its plans must be equal, and ``apply_permutation`` must take
what ``jnp.take`` takes."""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import (dequantize_int8,
                                                 quantize_int8)
from repro_torch.distributed import expert_placement as tep

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
#: the gradient tree of each rank: (leading rank dim, leaf shape)
TREE = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4)}}
RS_SHAPE = (4, 3)


def _inputs(step: int) -> dict:
    """Per-rank gradients (rank on the leading dim), from a numpy seed."""
    rng = np.random.default_rng(10 + step)

    def leaf(shape):
        return (rng.standard_normal((WORLD,) + shape) *
                rng.uniform(0.1, 3.0)).astype(np.float32)
    return {"a": leaf(TREE["a"]), "b": {"c": leaf(TREE["b"]["c"]),
                                        "d": leaf(TREE["b"]["d"])}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


_JAX = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.collectives import (compressed_psum_tree,
                                           reduce_scatter_then_gather)
from repro.launch.mesh import make_mesh_compat
sys.path.insert(0, sys.argv[2])
from test_torch_collectives import _inputs, _flat, RS_SHAPE, WORLD
mesh = make_mesh_compat((WORLD,), ("x",))
out = {}


def per_rank(f, *trees):
    spec = jax.tree_util.tree_map(lambda _: P("x"), trees)
    g = shard_map(lambda *a: f(*jax.tree_util.tree_map(lambda t: t[0], a)),
                  mesh=mesh, in_specs=spec, out_specs=P("x"),
                  check_vma=False)
    return g(*trees)


def expand(tree):
    return jax.tree_util.tree_map(lambda t: t[None], tree)


g1, g2 = _inputs(1), _inputs(2)
r1, fb1 = per_rank(lambda g: expand(compressed_psum_tree(g, "x")), g1)
r2, fb2 = per_rank(lambda g, e: expand(compressed_psum_tree(g, "x", e)),
                   g2, fb1)
for name, tree in (("plain", r1), ("fb1", fb1), ("fb_step", r2),
                   ("fb2", fb2)):
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, tree)).items():
        out[f"{name}/{k}"] = v
x = np.random.default_rng(3).standard_normal((WORLD,) + RS_SHAPE).astype(
    np.float32)


def rs(xx):
    shard, gather = reduce_scatter_then_gather(xx, "x")
    return shard[None], gather(shard * 2.0 + 1.0)[None]


sh, full = per_rank(lambda xx: rs(xx), x)
out["rs/shard"], out["rs/full"] = np.asarray(sh), np.asarray(full)
np.savez(sys.argv[1], **out)
"""


def _world(rank, init, path):
    """A rank of the port's world: the same calls on its own slices; rank
    0 saves every result."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (
        compressed_psum_tree, reduce_scatter_then_gather)
    torch.set_num_threads(1)       # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)

    def mine(tree):
        return {k: mine(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else torch.from_numpy(tree[rank])
    r1, fb1 = compressed_psum_tree(mine(_inputs(1)), dist.group.WORLD)
    r2, fb2 = compressed_psum_tree(mine(_inputs(2)), dist.group.WORLD, fb1)
    out = {}
    for name, tree in (("plain", r1), ("fb1", fb1), ("fb_step", r2),
                       ("fb2", fb2)):
        for k, v in _flat(tree).items():
            out[f"{name}/{k}"] = v.numpy()
    x = np.random.default_rng(3).standard_normal((WORLD,) + RS_SHAPE
                                                 ).astype(np.float32)
    shard, gather = reduce_scatter_then_gather(torch.from_numpy(x[rank]),
                                               dist.group.WORLD)
    out["rs/shard"] = shard.numpy()
    out["rs/full"] = gather(shard * 2.0 + 1.0).numpy()
    out.update(_redistributions(dist))
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, out)
    if rank == 0:
        np.savez(path, **{k: np.stack([g[k] for g in gathered])
                          for k in out})
    dist.destroy_process_group()


#: DTensor redistributions, each run with DTensor's own collectives and
#: through ``chip_smoke.classic_dtensor_collectives``: (from, to) placements on a
#: 1-D mesh of WORLD ranks
REDISTRIBUTIONS = {"shard_to_replicate": ("S0", "R"),
                   "partial_to_replicate": ("P", "R"),
                   "partial_to_shard": ("P", "S1"),
                   "shard_to_shard": ("S0", "S1")}


def _redistributions(dist) -> dict:
    """Each of REDISTRIBUTIONS, and a sharded product's gradient, both
    ways; the results as this rank's local arrays."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import classic_dtensor_collectives
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("x",))
    pl = {"S0": Shard(0), "S1": Shard(1), "R": Replicate(), "P": Partial()}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    out = {}
    for how in ("funcol", "classic"):
        ctx = classic_dtensor_collectives("cpu") if how == "classic" \
            else contextlib.nullcontext()
        with ctx:
            for name, (src, dst) in REDISTRIBUTIONS.items():
                if src == "P":
                    t = DTensor.from_local(x * (dist.get_rank() + 1), mesh,
                                           [pl[src]])
                else:
                    t = distribute_tensor(x, mesh, [pl[src]],
                                          src_data_rank=None)
                out[f"redist/{how}/{name}"] = t.redistribute(
                    mesh, [pl[dst]]).to_local().numpy()
            xd = distribute_tensor(x, mesh, [Shard(1)], src_data_rank=None
                                   ).requires_grad_()
            wd = distribute_tensor(w, mesh, [Shard(0)], src_data_rank=None
                                   ).requires_grad_()
            y = (xd @ wd).full_tensor()
            (y * y).sum().backward()
            out[f"redist/{how}/product"] = y.detach().numpy()
            out[f"redist/{how}/grad_w"] = wd.grad.full_tensor().numpy()
    return out


def test_classic_collectives_redistribute_as_dtensor_does(results):
    """``chip_smoke.classic_dtensor_collectives`` (DTensor's
    redistributions on the classic c10d calls, as phase 26 runs them on
    CUDA tensors over gloo)
    gives every rank DTensor's own blocks, bit for bit, and the same
    product and gradient."""
    _, tx = results
    names = list(REDISTRIBUTIONS) + ["product", "grad_w"]
    for name in names:
        np.testing.assert_array_equal(tx[f"redist/classic/{name}"],
                                      tx[f"redist/funcol/{name}"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD} "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",    # beside the worlds
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _JAX, str(d / "jax.npz"),
                        str(pathlib.Path(__file__).parent)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    torch.multiprocessing.spawn(_world, args=(
        f"file://{d / 'store'}", str(d / "torch.npz")), nprocs=WORLD)
    return np.load(d / "jax.npz"), np.load(d / "torch.npz")


@pytest.mark.parametrize("what", ["plain", "fb1", "fb_step", "fb2"])
def test_compressed_psum_tree_is_bit_equal(results, what):
    """Two steps of the int8 error-feedback sum (``plain``: no feedback;
    ``fb_step``: the second step fed the first's residual ``fb1``): every
    rank's sums and residuals bit-equal to the reference's."""
    jx, tx = results
    keys = [k for k in jx.files if k.startswith(what + "/")]
    assert keys and sorted(keys) == sorted(k for k in tx.files
                                           if k.startswith(what + "/"))
    for k in keys:
        assert tx[k].dtype == jx[k].dtype
        np.testing.assert_array_equal(tx[k], jx[k])


def test_reduce_scatter_then_gather_is_equal(results):
    jx, tx = results
    for k in ("rs/shard", "rs/full"):
        np.testing.assert_array_equal(tx[k], jx[k])
    # the gather returns every rank's updated shard, in rank order
    np.testing.assert_array_equal(tx["rs/full"][0], tx["rs/full"][1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_is_bit_equal(seed):
    import jax.numpy as jnp
    from repro.distributed.collectives import (dequantize_int8 as jdeq,
                                               quantize_int8 as jq)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((33, 17)) * 10 ** rng.uniform(-3, 3)
         ).astype(np.float32)
    x[0, 0] = 0.5 * float(np.abs(x).max())       # ties at .5 steps
    q, s = quantize_int8(torch.from_numpy(x))
    jqv, js = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jdeq(jqv, js)))


LOADS = {"uniform": (np.ones(8), 2), "skewed": (np.arange(16.0) ** 2, 4),
         "random": (np.random.default_rng(5).integers(0, 1000, 64), 8)}


@pytest.mark.parametrize("case", list(LOADS))
def test_expert_placement_plans_are_equal(case):
    import jax.numpy as jnp
    from repro.distributed import expert_placement as jep
    loads, n = LOADS[case]
    got = tep.plan_expert_placement(list(loads), n)
    want = jep.plan_expert_placement(list(loads), n)
    assert got.permutation == want.permutation
    assert got.shard_of_expert == want.shard_of_expert
    assert got.predicted_max_load == want.predicted_max_load
    assert got.baseline_max_load == want.baseline_max_load
    assert got.moves == want.moves
    assert got.improvement == want.improvement
    shape = (len(loads), 6, 4)
    assert [(b.lo, b.hi, b.owner, b.block_id)
            for b in tep.migration_blocks(got, shape)] == \
        [(b.lo, b.hi, b.owner, b.block_id)
         for b in jep.migration_blocks(want, shape)]
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for axis in (0,):
        np.testing.assert_array_equal(
            tep.apply_permutation(torch.from_numpy(w), got, axis).numpy(),
            np.asarray(jep.apply_permutation(jnp.asarray(w), want, axis)))
    with pytest.raises(ValueError, match="not divisible"):
        tep.plan_expert_placement(list(loads) + [1.0], n)
