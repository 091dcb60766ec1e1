"""ZeRO-1 moments and remat under a mesh, on the CPU in gloo worlds of 2
spawned ranks, qwen2.5-3b's smoke config in f32.

* A ``make_train_step`` step on mesh (data 2, model 1) with moments placed
  by ``adamw_init(zero1=True)`` (``zero_moment_defs``: each rank holds
  half of m and v) gives params bit-equal to the same step with
  replicated moments, and m and v bit-equal once gathered; its first
  moments equal the JAX package's jitted step with m and v placed by
  ``zero_moment_defs`` on 2 host devices (within 1e-4 of each leaf's
  max).
* On mesh (1, 2) the sharded gradients under ``remat="dots"`` and
  ``"full"`` equal those under ``"none"`` (within 1e-6 of each leaf's
  max), and the backward runs as many collectives under remat as
  without: the policy keeps every reduction's output, so a layer's
  recompute issues none here, where the layers gather nothing (counted
  by ``chip_smoke``'s classic collectives on CPU tensors; an FSDP
  weight's gather is issued again, ``models/model.
  _collectives_saveable``).  The backward runs on a thread of its own,
  as a card's autograd device thread does, where the forward's
  thread-local sharding context is not active: the recompute re-enters
  it.
* A batch-1 KV cache split over its sequence on mesh (1, 2): the
  prefill's cache and two decode steps of an attention layer equal the
  whole-tensor run's.
* ``grad_accum`` on a batch split over "data" (mesh (2, 1)) splits each
  rank's own rows, and its moments equal the unsharded step's."""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
OPT = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
GRAD_GAP, REMAT_GAP = 1e-4, 1e-6
#: f32 sums over other groups of rows, in another order
ACCUM_GAP = 1e-5

_JAX = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_reduce_once as T
import test_torch_zero1 as Z
import repro.models.layers as jlayers
from repro.configs import get_smoke_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
from repro.models import LM
from repro.train.optimizer import (OptimizerConfig, zero_moment_defs)
from repro.train.trainer import make_train_step
jlayers._COMPUTE = jnp.float32
model = LM(get_smoke_config(Z.ARCH))
flat = T._params(Z.ARCH)
skel = model.skeleton()
mesh = make_mesh_compat((2, 1), ("data", "model"))
out = {}
with mesh, shd.use_sharding(mesh, shd.DEFAULT_RULES):
    place = lambda a, d: jax.device_put(jnp.asarray(a), shd.named_sharding(
        d.axes, d.shape))
    is_def = lambda x: hasattr(x, "init")
    params = jax.tree_util.tree_map(place, T._nest(flat), skel,
                                    is_leaf=is_def)
    mdefs = zero_moment_defs(skel)
    zeros = lambda d: jax.device_put(jnp.zeros(d.shape, jnp.float32),
                                     shd.named_sharding(d.axes, d.shape))
    opt = {"m": jax.tree_util.tree_map(zeros, mdefs, is_leaf=is_def),
           "v": jax.tree_util.tree_map(zeros, mdefs, is_leaf=is_def),
           "count": jnp.zeros((), jnp.int32)}
    b = {k: jnp.asarray(v) for k, v in T._batches(model.cfg.vocab)[0].items()}
    step = jax.jit(make_train_step(model, OptimizerConfig(**Z.OPT), 1))
    params, opt, m = step(params, opt, b)
for n, a in zip(sorted(flat), jax.tree_util.tree_leaves(opt["m"])):
    out["m/" + n] = np.asarray(a)
out["sharded"] = np.array([len(x.sharding.device_set) > 1 and
                           x.sharding.spec != jax.sharding.PartitionSpec()
                           for x in jax.tree_util.tree_leaves(opt["m"])])
np.savez(sys.argv[1], **out)
"""


def _world(rank, init, out_path):
    import torch.distributed as dist
    import dataclasses
    from torch.distributed.tensor import distribute_tensor
    import repro_torch.models.layers as tlayers
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke
    import test_torch_reduce_once as T
    from repro_torch.checkpoint.blocks_map import flatten_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, adamw_init, \
        make_train_step
    from repro_torch.models.model import plain_as_replicated
    from repro_torch.models.params import tree_map
    from repro_torch.train.trainer import place_batch
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    tlayers._COMPUTE = torch.float32
    flat = T._params(ARCH)
    out = {}

    def placed(model, ctx):
        defs = flatten_pytree(model.skeleton())
        return T._nest({n: distribute_tensor(
            torch.tensor(a), ctx.mesh, ctx.placements(
                defs[n].axes, a.shape), src_data_rank=None)
            for n, a in flat.items()})

    model = LM(get_smoke_config(ARCH), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             T._batches(model.cfg.vocab)[0].items()}
    step = make_train_step(model, OptimizerConfig(**OPT))
    with shd.use_sharding(make_mesh((2, 1), ("data", "model"), "cpu"),
                          shd.DEFAULT_RULES) as ctx:
        runs = {}
        for tag, zero1 in (("replicated", False), ("zero1", True)):
            params = placed(model, ctx)
            opt = adamw_init(params, zero1=zero1,
                             skeleton=model.skeleton())
            step(params, opt, place_batch(batch))
            runs[tag] = (params, opt)
        for tag, (params, opt) in runs.items():
            for what, tree in (("params", params), ("m", opt["m"]),
                               ("v", opt["v"])):
                for n, t in flatten_pytree(tree).items():
                    out[f"{tag}/{what}/{n}"] = t.full_tensor().numpy()
            out[f"{tag}/local_moment_bytes"] = np.array(sum(
                t.to_local().numel() * 4 for k in ("m", "v")
                for t in flatten_pytree(opt[k]).values()))
        # microbatches of a batch split over "data": each rank's own rows
        # (2 a rank: 2 microbatches; asked for 4, one row a rank each)
        for accum in (2, 4):
            params = placed(model, ctx)
            opt = adamw_init(params)
            make_train_step(model, OptimizerConfig(**OPT), accum)(
                params, opt, place_batch(batch))
            for n, t in flatten_pytree(opt["m"]).items():
                out[f"accum/{accum}/{n}"] = t.full_tensor().numpy()
    params = T._nest({n: torch.tensor(a) for n, a in flat.items()})
    opt = adamw_init(params)
    make_train_step(model, OptimizerConfig(**OPT), 2)(params, opt, batch)
    for n, t in flatten_pytree(opt["m"]).items():
        out[f"accum/plain/{n}"] = t.numpy()
    with shd.use_sharding(make_mesh((1, 2), ("data", "model"), "cpu"),
                          shd.DEFAULT_RULES) as ctx:
        for remat in ("none", "dots", "full"):
            rm = LM(dataclasses.replace(get_smoke_config(ARCH),
                                        remat=remat), device="cpu")
            params = placed(rm, ctx)
            grads = tree_map(torch.zeros_like, params)
            counts = chip_smoke.CLASSIC_COUNTS
            counts.update(forward=0, backward=0)
            with chip_smoke.classic_dtensor_collectives("cpu"), \
                    torch.enable_grad(), plain_as_replicated(params):
                loss, _ = rm.loss(rm.trainable(params, grads),
                                  place_batch(batch))
                # the backward on a thread of its own, as on a card's
                # autograd device thread: the engine carries the caller's
                # C++ thread-local state there (DTensor's implicit
                # replication), not the Python one (the sharding context)
                errors = []

                def backward():
                    try:
                        with shd.replicate_plain():
                            loss.backward()
                    except BaseException as e:   # noqa: BLE001 - below
                        errors.append(e)
                t = threading.Thread(target=backward)
                t.start()
                t.join()
                if errors:
                    raise errors[0]
            out[f"remat/{remat}/collectives"] = np.array(
                [counts["forward"], counts["backward"]])
            for n, t in flatten_pytree(grads).items():
                out[f"remat/{remat}/{n}"] = t.full_tensor().numpy()
        # a batch-1 KV cache split over its sequence (kv_seq) on "model":
        # the prefill's k, v into each rank's slots, then 2 decode steps of
        # one attention layer, against the same on whole tensors
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.models import attention as tattn
        from repro_torch.models import transformer as tfm
        rng = np.random.default_rng(5)
        H, K, D, M, L, S = 4, 2, 16, 32, 12, 16
        ad = tattn.attn_defs(M, H, K, D)
        ap = {n: torch.from_numpy((rng.standard_normal(d.shape)
                                   / np.sqrt(M)).astype(np.float32))
              for n, d in ad.items()}
        kv = {n: torch.from_numpy(rng.standard_normal(
            (1, L, K, D)).astype(np.float32)) for n in ("k", "v")}
        xs = [torch.from_numpy(rng.standard_normal((1, 1, M)).astype(
            np.float32)) for _ in range(2)]
        cdefs = tattn.init_kv_cache_defs(1, S, K, D, seq_sharded=True)
        rep = (Replicate(), Replicate())
        dp = {n: distribute_tensor(t, ctx.mesh, ctx.placements(
            ad[n].axes, t.shape), src_data_rank=None) for n, t in ap.items()}
        dkv = {n: distribute_tensor(t, ctx.mesh, rep, src_data_rank=None)
               for n, t in kv.items()}
        kw = dict(n_heads=H, n_kv=K, head_dim=D)
        with torch.no_grad(), shd.replicate_plain():
            split = tfm._kv_to_cache(dkv, cdefs, L)
            out["seq_split"] = np.array(split["k"].placements[1].is_shard(1))
            whole = {n: t.full_tensor() for n, t in split.items()}
            for i, x in enumerate(xs):
                y, split = tattn.attn_decode(dp, distribute_tensor(
                    x, ctx.mesh, rep, src_data_rank=None), split, L + i,
                    **kw)
                yw, whole = tattn.attn_decode(ap, x, whole, L + i, **kw)
                out[f"serve/split/{i}"] = y.full_tensor().numpy()
                out[f"serve/whole/{i}"] = yw.numpy()
            out["serve/split/cache"] = split["k"].full_tensor().float(
                ).numpy()
            out["serve/whole/cache"] = whole["k"].float().numpy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero1")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",    # beside the world
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _JAX, str(d / "jax.npz"),
                            str(pathlib.Path(__file__).parent)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        torch.multiprocessing.spawn(_world, args=(
            f"file://{d / 'store'}", str(d / "torch.npz")), nprocs=2)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return np.load(d / "jax.npz"), np.load(d / "torch.npz")


def test_zero1_step_is_bit_equal_to_the_replicated_step(results):
    _, tx = results
    names = [k.split("/", 1)[1] for k in tx.files
             if k.startswith("replicated/") and "/" in k.split("/", 1)[1]]
    assert names
    for n in names:
        np.testing.assert_array_equal(tx[f"zero1/{n}"],
                                      tx[f"replicated/{n}"])
    # each data rank holds half of m and v (every smoke leaf splits)
    assert 2 * int(tx["zero1/local_moment_bytes"]) == \
        int(tx["replicated/local_moment_bytes"])


def test_zero1_moments_match_the_reference_step(results):
    jx, tx = results
    assert jx["sharded"].any()
    for k in jx.files:
        if not k.startswith("m/"):
            continue
        want, got = jx[k], tx[f"zero1/{k}"]
        gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert gap < GRAD_GAP, (k, gap)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_splits_each_ranks_rows(results, accum):
    """``make_train_step`` with ``grad_accum`` on a batch split over
    "data" takes each rank's own rows a microbatch (``trainer.
    _split_sharded``; 4 asks for more microbatches than a rank's 2 rows:
    2 of one row a rank): its first moments (linear in the mean
    gradient) equal the unsharded step's, whose 2 microbatches hold
    other rows, within f32 summation order (1e-5 of each leaf's max)."""
    _, tx = results
    names = [k.split("/", 2)[2] for k in tx.files
             if k.startswith("accum/plain/")]
    assert names
    for n in names:
        want, got = tx[f"accum/plain/{n}"], tx[f"accum/{accum}/{n}"]
        gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert gap < ACCUM_GAP, (n, gap)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_sharded_gradients_equal_no_remat(results, remat):
    _, tx = results
    names = [k.split("/", 2)[2] for k in tx.files
             if k.startswith("remat/none/") and not k.endswith("collectives")]
    for n in names:
        want, got = tx[f"remat/none/{n}"], tx[f"remat/{remat}/{n}"]
        gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert gap < REMAT_GAP, (n, gap)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recompute_issues_no_collective(results, remat):
    _, tx = results
    none = tx["remat/none/collectives"]
    assert none[1] > 0
    np.testing.assert_array_equal(tx[f"remat/{remat}/collectives"], none)


def test_seq_split_decode_matches_the_whole_cache(results):
    """A batch-1 KV cache split over its sequence on "model"
    (``kv_seq``): the prefill fills each rank's slots, each decode step
    writes its token into the rank that holds its slot and combines the
    ranks' partial softmaxes; outputs and cache equal the whole-tensor
    run's."""
    _, tx = results
    assert bool(tx["seq_split"])
    for i in range(2):
        np.testing.assert_allclose(tx[f"serve/split/{i}"],
                                   tx[f"serve/whole/{i}"], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(tx["serve/split/cache"],
                                  tx["serve/whole/cache"])
