"""bfloat16 container variables (S9) against the JAX package's, on the
CPU: the same bf16 blocks written by both packages give the same
``index.json`` and the same subfile bytes under every layout, with and
without a codec; bf16 leaves and a 0-d bf16 scalar checkpoint and restore
across the packages both ways; and the port does all of it with
``ml_dtypes`` blocked, as on a machine that lacks it."""

import json
import os
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.io as jio
import repro.core.codecs as jcodecs
import repro.io.format as jformat
import repro.io.reader as jreader
import repro.io.replay as jreplay
from repro.checkpoint import CheckpointManager as JManager
from repro.core.blocks import Block as JBlock

import repro_torch.core as tc
import repro_torch.io.replay as treplay
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.blocks import Block
from repro_torch.interop import blocks_from_records, to_numpy
from repro_torch.io import (Dataset, TraceHeader, TraceRecorder,
                            header_for_dataset, load_trace)
from repro_torch.io.format import BF16_STORAGE, dtype_name, storage_dtype

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE, BLOCK, NPROCS, PPN = (64, 96), (16, 32), 6, 2
SUB = ((5, 17), (50, 90))
BF16 = ml_dtypes.bfloat16


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(SHAPE, BLOCK),
                                  num_procs=NPROCS, seed=5)
    field = rng.standard_normal(SHAPE).astype(BF16)
    data = {b.block_id: np.ascontiguousarray(field[b.slices()]) for b in jb}
    tb = blocks_from_records([(b.lo, b.hi, b.owner, b.block_id)
                              for b in jb])
    return jb, tb, field, data


@pytest.fixture
def jax_writes_bf16(monkeypatch):
    """The JAX package's CRC-32 and codecs take a ``memoryview`` of a chunk
    buffer, which numpy cannot make of an ``ml_dtypes`` array ("cannot
    include dtype 'E' in a buffer"): every bf16 write of its own raises
    there (its ``examples/serve_batched.py`` stops at the snapshot for
    this).  For the oracle, its ``Dataset`` module gets the same bytes
    viewed as uint8: the checksums and compressed extents it would write."""
    as_bytes = (lambda b: np.ascontiguousarray(b).reshape(-1)
                .view(np.uint8))
    monkeypatch.setattr(jreader, "extent_checksum",
                        lambda b: jformat.extent_checksum(as_bytes(b)))
    monkeypatch.setattr(jreader, "encode",
                        lambda codec, b: jcodecs.encode(codec, as_bytes(b)))


def _index(d):
    with open(os.path.join(d, "index.json")) as f:
        return json.load(f)


def _bits(t):
    return to_numpy(t)              # a bf16 tensor's int16 bit pattern


def test_dtype_names():
    """One map: numpy dtypes, torch dtypes and stored names to the stored
    name and the host's working dtype; bf16's stand-in keeps its name."""
    for dt in ("bfloat16", torch.bfloat16, BF16_STORAGE, BF16,
               np.dtype(BF16)):
        assert dtype_name(dt) == "bfloat16"
        assert storage_dtype(dt) is BF16_STORAGE
    assert dtype_name(np.empty(3, BF16_STORAGE)[1:].reshape(1, 2).dtype) \
        == "bfloat16"
    for dt, name in ((np.float32, "float32"), ("f8", "float64"),
                     (torch.float32, "float32"), (torch.int64, "int64"),
                     (torch.uint8, "uint8"), (np.dtype(np.int16), "int16"),
                     (torch.bool, "bool")):
        assert dtype_name(dt) == name
        assert storage_dtype(dt) == np.dtype(name)
    assert BF16_STORAGE.itemsize == 2


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("strategy", tc.STRATEGIES)
def test_bf16_dataset_equals_the_reference(tmp_path, world, strategy, codec,
                                          jax_writes_bf16):
    """The port writes bf16 tensors (its device route, the plain kernels on
    the CPU) and bf16 ndarrays (the host route): ``index.json`` and every
    subfile equal the JAX package's; the port reads the whole variable and
    a part back bit for bit, as bf16 tensors, and the JAX package reads
    the port's dataset."""
    jb, tb, field, data = world
    kw = dict(num_procs=NPROCS, procs_per_node=PPN, num_stagers=3)
    jl, tl = jc.plan_layout(strategy, jb, **kw), tc.plan_layout(strategy, tb,
                                                                 **kw)
    jd = jio.Dataset.create(str(tmp_path / "jax"), telemetry=False)
    jd.write("K", jl, BF16, data, codec=codec)
    jd.close()
    tensors = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
               for k, v in data.items()}
    for name, blocks, dtype in (("tensors", tensors, torch.bfloat16),
                                ("ndarrays", data, "bfloat16")):
        d = tmp_path / name
        ds = Dataset.create(str(d), device="cpu")
        ds.write("K", tl, dtype, blocks, codec=codec)
        ds.close()
        assert _index(d) == _index(tmp_path / "jax")
        for f in sorted(os.listdir(tmp_path / "jax")):
            if f.endswith(".bin"):
                assert (d / f).read_bytes() == (tmp_path / "jax" / f
                                                ).read_bytes()
        ds = Dataset.open(str(d), device="cpu")
        got, _ = ds.read("K", Block((0, 0), SHAPE))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), field.view(np.int16))
        part, _ = ds.read("K", Block(*SUB))
        np.testing.assert_array_equal(
            _bits(part), field[SUB[0][0]:SUB[1][0],
                               SUB[0][1]:SUB[1][1]].view(np.int16))
        ds.close()
        back, _ = jio.Dataset.open(str(d), telemetry=False).read(
            "K", JBlock((0, 0), SHAPE))
        assert back.dtype == BF16
        np.testing.assert_array_equal(back.view(np.int16),
                                      field.view(np.int16))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"kv": torch.randn(8, 6, 4, generator=g).to(torch.bfloat16),
            "w": torch.randn(5, 3, generator=g),
            "s": torch.tensor(1.0 / 3.0).to(torch.bfloat16),
            "n": torch.tensor(7, dtype=torch.int32)}


def _block_map():
    """The bf16 leaf from 2 hosts, as a sharded KV cache would come."""
    return {"kv": [Block((0, 0, 0), (4, 6, 4), owner=0, block_id=0),
                   Block((4, 0, 0), (8, 6, 4), owner=1, block_id=1)]}


def test_bf16_checkpoint_port_to_jax(tmp_path, jax_writes_bf16):
    """bf16 leaves (one sharded over 2 hosts) and a 0-d bf16 scalar: the
    port's save restores under the JAX package and under the port bit for
    bit; the manifest and ``index.json`` equal the JAX package's save of
    the same tree."""
    tree = _tree()
    CheckpointManager(str(tmp_path / "port"), strategy="merged_process",
                      device="cpu").save(0, tree, block_map=_block_map())
    jtree = {k: (to_numpy(v, BF16) if v.dtype == torch.bfloat16
                 else v.numpy()) for k, v in tree.items()}
    jmap = {"kv": [JBlock(b.lo, b.hi, owner=b.owner, block_id=b.block_id)
                   for b in _block_map()["kv"]]}
    JManager(str(tmp_path / "jax"), strategy="merged_process").save(
        0, jtree, block_map=jmap)
    pdir, jdir = (next((tmp_path / r).glob("step_*")) for r in ("port",
                                                                 "jax"))
    assert _index(pdir) == _index(jdir)
    with open(pdir / "manifest.json") as f, open(jdir / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    got, _ = JManager(str(tmp_path / "port")).restore(0)
    for k, v in jtree.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(
            np.asarray(got[k]).reshape(-1).view(np.uint8),
            np.asarray(v).reshape(-1).view(np.uint8))
    back, _ = CheckpointManager(str(tmp_path / "port"), device="cpu"
                                ).restore(0)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_bf16_checkpoint_jax_to_port(tmp_path, jax_writes_bf16):
    """The JAX package's save of bf16 leaves and a 0-d bf16 scalar restores
    under the port as bf16 tensors, bit for bit, whole and onto a new
    decomposition."""
    rng = np.random.default_rng(1)
    jtree = {"kv": rng.standard_normal((8, 6, 4)).astype(BF16),
             "s": np.asarray(2.5, BF16)}
    JManager(str(tmp_path), strategy="subfiled_fpp").save(3, jtree)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    back, _ = mgr.restore(3)
    assert back["s"].dtype == torch.bfloat16 and back["s"].dim() == 0
    assert float(back["s"]) == 2.5
    np.testing.assert_array_equal(_bits(back["kv"]),
                                  jtree["kv"].view(np.int16))
    targets = [Block((0, 0, 0), (3, 6, 4), block_id=0),
               Block((3, 2, 0), (8, 6, 4), block_id=1)]
    shards, _ = mgr.restore(3, target_blocks={"kv": targets})
    for b in targets:
        np.testing.assert_array_equal(
            _bits(shards["kv"][b.block_id]),
            jtree["kv"][b.slices()].view(np.int16))


def test_bf16_replay_synth_equals_the_reference():
    """A replayed bf16 variable's content is the reference's, bit for bit,
    made without ``ml_dtypes`` (the reference's bfloat16 is of numpy kind
    "V": zeros and ones)."""
    got = treplay._synth(7, 3, (33, 5), "bfloat16")
    want = jreplay._synth(7, 3, (33, 5), "bfloat16")
    assert dtype_name(got.dtype) == "bfloat16" and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))


def test_bf16_trace_names_the_dtype(tmp_path):
    """A captured bf16 write and the header's snapshot say
    ``"bfloat16"``, as the reference's trace does."""
    rec = TraceRecorder(str(tmp_path / "t.jsonl"), TraceHeader())
    ds = Dataset.create(str(tmp_path / "d"), device="cpu")
    ds.attach_trace(rec)
    blocks = [Block((0, 0), (4, 8), owner=0, block_id=0)]
    lay = tc.plan_layout("merged_process", blocks, num_procs=1)
    ds.write("K", lay, torch.bfloat16,
             {0: torch.ones(4, 8, dtype=torch.bfloat16)})
    ds.close()
    rec.close()
    ev = load_trace(str(tmp_path / "t.jsonl")).events
    assert [e.params["dtype"] for e in ev if e.kind == "write"] == \
        ["bfloat16"]
    hdr = header_for_dataset(Dataset.open(str(tmp_path / "d"), device="cpu"))
    assert hdr.variables["K"]["dtype"] == "bfloat16"


NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # as on a machine without it
import numpy as np, torch
try:
    np.dtype("bfloat16")
    raise SystemExit("bfloat16 resolved: ml_dtypes is not blocked")
except TypeError:
    pass
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import plan_layout
from repro_torch.core.blocks import Block
from repro_torch.io import Dataset, StagingExecutor
root = sys.argv[1]
g = torch.Generator().manual_seed(0)
x = torch.randn(16, 24, generator=g).to(torch.bfloat16)
blocks = [Block((0, 0), (16, 12), owner=0, block_id=0),
          Block((0, 12), (16, 24), owner=1, block_id=1)]
data = {b.block_id: x[b.slices()] for b in blocks}
for codec in ("none", "zlib"):
    d = f"{root}/ds_{codec}"
    ds = Dataset.create(d, device="cpu")
    lay = plan_layout("reorganized", blocks, num_procs=2, global_shape=(16, 24),
                      reorg_scheme=(2, 3))
    ds.write("K", lay, torch.bfloat16, data, codec=codec)
    ds.write("H", lay, "bfloat16",
             {k: v.view(torch.int16).numpy() for k, v in data.items()},
             codec=codec)
    ds.close()
    ds = Dataset.open(d, device="cpu")
    for var in ("K", "H"):
        got, _ = ds.read(var, Block((0, 0), (16, 24)))
        assert got.dtype == torch.bfloat16 and torch.equal(got, x), var
        part, _ = ds.read(var, Block((3, 5), (11, 20)))
        assert torch.equal(part, x[3:11, 5:20]), var
    assert ds.index.variables["K"]["dtype"] == "bfloat16"
    ds.close()
tree = {"kv": x, "s": torch.tensor(0.1).to(torch.bfloat16),
        "w": torch.ones(3)}
mgr = CheckpointManager(f"{root}/ck", strategy="merged_process", device="cpu")
mgr.save(0, tree, block_map={"kv": blocks})
back, _ = mgr.restore(0)
assert all(back[k].dtype == v.dtype and torch.equal(back[k], v)
           for k, v in tree.items())
shards, _ = mgr.restore(0, target_blocks={"kv": [
    Block((2, 2), (9, 20), block_id=5)]})
assert torch.equal(shards["kv"][5], x[2:9, 2:20])
st = StagingExecutor(f"{root}/st", num_workers=1, device="cpu")
st.submit(0, "K", torch.bfloat16, plan_layout(
    "reorganized", blocks, num_procs=0, global_shape=(16, 24),
    reorg_scheme=(2, 2)), data)
st.close()
got, _ = Dataset.open(f"{root}/st", device="cpu").read(
    "K@0", Block((0, 0), (16, 24)))
assert torch.equal(got, x)
assert "ml_dtypes" not in [k for k, v in sys.modules.items() if v is not None]
print("ok")
"""


def test_bf16_without_ml_dtypes(tmp_path):
    """Datasets (both routes, raw and compressed, tensors and ndarrays),
    checkpoints (sharded, elastic, a 0-d scalar) and staging of bf16 in a
    process where ``import ml_dtypes`` fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", NO_ML_DTYPES, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
