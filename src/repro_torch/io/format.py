"""Log-structured dataset container (ADIOS2-BP-motif, paper §2.2–2.3).

A *dataset* is a directory holding:
  * one or more ``data_<k>.bin`` subfiles — extents appended log-style, the
    chunk's position in the global array is NOT encoded in file order;
  * ``index.json`` — the metadata the paper notes ADIOS2 must keep: for every
    chunk, its global cuboid ``[lo, hi)``, its subfile, byte offset and size,
    plus (format version 2) a per-variable spatial chunk index so readers
    locate intersecting chunks without scanning the whole record list, plus
    (format version 3) an optional per-chunk CRC-32 checksum of the stored
    extent bytes, so recovery paths can *validate* a partially-built
    destination instead of trusting it, plus (format version 4) an optional
    per-chunk *codec*: ``nbytes`` is always the STORED on-disk size and
    ``lbytes`` the logical (decoded) size, so every byte-offset consumer —
    planner, append cursor, journal CRC validation, ``verify_checksums`` —
    keeps working on stored bytes unchanged.  Version-2 files (no
    checksums) and version-3 files (no codecs) load transparently; absent
    keys mean "no checksum" / "codec none".

Optional 16 MiB extent alignment mirrors GPFS's internal block size on Summit
(§3.2: "GPFS internally splits big data chunks into 16MB blocks").
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Sequence

import numpy as np

from ..core.blocks import Block
from ..core.codecs import codec_code
from .spatial import SpatialChunkIndex

__all__ = ["ChunkRecord", "DatasetIndex", "VarRows", "GPFS_BLOCK",
           "subfile_name", "align_up", "extent_checksum", "dtype_name",
           "storage_dtype", "BF16_STORAGE"]

GPFS_BLOCK = 16 * 1024 * 1024
INDEX_NAME = "index.json"
INDEX_VERSION = 4
#: index versions this reader understands (v1: no spatial payload; v2: no
#: checksums; v3: optional per-chunk CRC-32 of each stored extent; v4:
#: optional per-chunk codec + logical size) — all older versions load
#: transparently, unknown *newer* versions fail loudly
SUPPORTED_INDEX_VERSIONS = (1, 2, 3, 4)


#: the host's stand-in for a bfloat16 variable: numpy has no bfloat16 of
#: its own, so the host's byte work (planning, engines, checksums) runs on
#: 2-byte integers holding the bf16 bits.  The metadata carries the stored
#: name, so :func:`dtype_name` gives ``"bfloat16"`` back for it, and for
#: arrays made with it; on the card the tensors are ``torch.bfloat16``
BF16_STORAGE = np.dtype("<i2", metadata={"stored_as": "bfloat16"})


def dtype_name(dtype) -> str:
    """The name a variable's dtype is stored under in ``index.json``, the
    journal, the trace and ``manifest.json``: numpy's name, and
    ``"bfloat16"`` for the string, ``torch.bfloat16``, the host stand-in
    :data:`BF16_STORAGE` (or an array dtype made from it) and a numpy
    extension type of that name."""
    if isinstance(dtype, str):
        return dtype if dtype == "bfloat16" else np.dtype(dtype).name
    if type(dtype).__module__ == "torch":            # a torch.dtype
        name = str(dtype).rpartition(".")[2]
        return name if name == "bfloat16" else np.dtype(name).name
    meta = getattr(dtype, "metadata", None)
    if meta and "stored_as" in meta:
        return meta["stored_as"]
    if getattr(dtype, "__name__", None) == "bfloat16" or \
            getattr(dtype, "name", None) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def storage_dtype(dtype) -> np.dtype:
    """The numpy dtype the host works in for ``dtype`` (a numpy dtype, a
    torch dtype or a stored name): :data:`BF16_STORAGE` for bfloat16,
    else the dtype itself."""
    name = dtype_name(dtype)
    return BF16_STORAGE if name == "bfloat16" else np.dtype(name)


def extent_checksum(buf) -> int:
    """CRC-32 of one stored extent's bytes (the format-v3 per-chunk
    checksum).  Accepts any buffer-protocol object — engines and recovery
    paths feed raw ``uint8`` views of the extent."""
    return zlib.crc32(memoryview(buf).cast("B")) & 0xFFFFFFFF


def subfile_name(k: int) -> str:
    return f"data_{k}.bin"


def align_up(x: int, align: int | None) -> int:
    if not align:
        return x
    return ((x + align - 1) // align) * align


@dataclasses.dataclass
class ChunkRecord:
    var: str
    lo: tuple
    hi: tuple
    subfile: int
    offset: int
    #: STORED size of the extent on disk (compressed size when ``codec`` is
    #: not ``"none"``) — every byte-offset consumer (append cursor, journal
    #: CRC validation, ``verify_checksums``) works on stored bytes
    nbytes: int
    #: CRC-32 of the stored extent bytes (format v3); ``None`` for records
    #: loaded from v2 indexes or written without checksumming
    checksum: int | None = None
    #: per-chunk codec name (format v4); ``"none"`` = raw bytes
    codec: str = "none"
    #: logical (decoded) size in bytes; ``None`` means equal to ``nbytes``
    #: (always the case for ``codec="none"``)
    lbytes: int | None = None

    @property
    def block(self) -> Block:
        return Block(tuple(self.lo), tuple(self.hi))

    @property
    def logical_nbytes(self) -> int:
        """Decoded size of the extent (== ``nbytes`` for raw chunks)."""
        return self.nbytes if self.lbytes is None else self.lbytes

    def to_json(self) -> dict:
        d = {"var": self.var,
             "lo": [int(v) for v in self.lo],
             "hi": [int(v) for v in self.hi],
             "subfile": int(self.subfile), "offset": int(self.offset),
             "nbytes": int(self.nbytes)}
        if self.checksum is not None:
            d["crc"] = int(self.checksum)
        if self.codec != "none":
            d["codec"] = self.codec
            d["lbytes"] = int(self.logical_nbytes)
        return d

    @staticmethod
    def from_json(d: dict) -> "ChunkRecord":
        return ChunkRecord(var=d["var"], lo=tuple(d["lo"]), hi=tuple(d["hi"]),
                           subfile=d["subfile"], offset=d["offset"],
                           nbytes=d["nbytes"], checksum=d.get("crc"),
                           codec=d.get("codec", "none"),
                           lbytes=d.get("lbytes"))


@dataclasses.dataclass(frozen=True)
class VarRows:
    """Columnar view of one variable's chunk records (cached per variable).

    ``ids[i]`` is the record's position in ``DatasetIndex.chunks``; the other
    arrays are row-aligned with ``ids``.
    """

    ids: np.ndarray          # (n,)  positions into DatasetIndex.chunks
    los: np.ndarray          # (n,d) chunk low corners
    his: np.ndarray          # (n,d) chunk high corners
    subfiles: np.ndarray     # (n,)
    offsets: np.ndarray      # (n,)  byte offset of each extent
    nbytes: np.ndarray       # (n,)  STORED extent sizes (on-disk bytes)
    codecs: np.ndarray       # (n,)  small-int codec codes (0 = none)
    lbytes: np.ndarray       # (n,)  logical (decoded) extent sizes

    @property
    def n(self) -> int:
        return len(self.ids)


@dataclasses.dataclass
class DatasetIndex:
    variables: dict = dataclasses.field(default_factory=dict)
    #: append-only — row/spatial caches are invalidated by record COUNT, so
    #: records must never be replaced or reordered in place
    chunks: list = dataclasses.field(default_factory=list)
    num_subfiles: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    #: layout generation: bumped (old + 1) every time a reorganization
    #: republishes the index with *relocated* extents — in-place online
    #: reorganize and the distributed fleet's commit both stamp it.  Plain
    #: appends do not bump it (existing extents never move), so cached
    #: read plans are stale iff ``(generation, len(chunks))`` changed.
    #: Pre-generation index files load as generation 0.
    generation: int = 0
    #: persisted spatial-index payloads per variable (format v2)
    spatial: dict = dataclasses.field(default_factory=dict, repr=False)
    _rows: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)
    _spatial_built: dict = dataclasses.field(default_factory=dict, repr=False,
                                             compare=False)
    _cache_token: int = dataclasses.field(default=-1, repr=False,
                                          compare=False)

    def add_variable(self, name: str, shape: Sequence[int], dtype,
                     strategy: str = "") -> None:
        self.variables[name] = {"shape": list(shape),
                                "dtype": dtype_name(dtype),
                                "strategy": strategy}

    def var_shape(self, name: str) -> tuple:
        return tuple(self.variables[name]["shape"])

    def var_dtype(self, name: str) -> np.dtype:
        return storage_dtype(self.variables[name]["dtype"])

    def chunks_of(self, name: str) -> list:
        return [c for c in self.chunks if c.var == name]

    # -- spatial lookup ------------------------------------------------------
    def _check_cache(self) -> None:
        if self._cache_token != len(self.chunks):
            self._rows.clear()
            self._spatial_built.clear()
            self._cache_token = len(self.chunks)

    def var_rows(self, name: str) -> VarRows:
        """Columnar arrays for one variable's records (built once, cached).

        All variables' rows are grouped in a single pass over the record
        list, so repeated saves of many-variable datasets (checkpoints) stay
        O(n) instead of O(vars * n).
        """
        self._check_cache()
        if name not in self._rows:
            by_var: dict = {v: [] for v in self.variables}
            for i, c in enumerate(self.chunks):
                by_var.setdefault(c.var, []).append(i)
            for var, id_list in by_var.items():
                ids = np.asarray(id_list, dtype=np.int64)
                ndim = len(self.var_shape(var)) if var in self.variables \
                    else (len(self.chunks[id_list[0]].lo) if id_list else 0)
                los = np.empty((len(ids), ndim), dtype=np.int64)
                his = np.empty((len(ids), ndim), dtype=np.int64)
                subfiles = np.empty(len(ids), dtype=np.int64)
                offsets = np.empty(len(ids), dtype=np.int64)
                nbytes = np.empty(len(ids), dtype=np.int64)
                codecs = np.zeros(len(ids), dtype=np.int64)
                lbytes = np.empty(len(ids), dtype=np.int64)
                for r, i in enumerate(id_list):
                    c = self.chunks[i]
                    los[r] = c.lo
                    his[r] = c.hi
                    subfiles[r] = c.subfile
                    offsets[r] = c.offset
                    nbytes[r] = c.nbytes
                    if c.codec != "none":
                        codecs[r] = codec_code(c.codec)
                    lbytes[r] = c.logical_nbytes
                self._rows[var] = VarRows(ids=ids, los=los, his=his,
                                          subfiles=subfiles, offsets=offsets,
                                          nbytes=nbytes, codecs=codecs,
                                          lbytes=lbytes)
        return self._rows[name]

    def spatial_index(self, name: str) -> SpatialChunkIndex:
        """The variable's spatial chunk index — loaded from the persisted v2
        payload when it matches, else (re)built from the records."""
        self._check_cache()
        sp = self._spatial_built.get(name)
        if sp is None:
            rows = self.var_rows(name)
            payload = self.spatial.get(name)
            if payload is not None and payload.get("n") == rows.n:
                sp = SpatialChunkIndex.from_json(payload, rows.los, rows.his)
            else:
                sp = SpatialChunkIndex(rows.los, rows.his)
            self._spatial_built[name] = sp
        return sp

    # -- persistence --------------------------------------------------------
    def save(self, dirpath: str) -> None:
        # spatial_index() reuses a persisted payload whenever the variable's
        # record count is unchanged (records are append-only), so repeated
        # saves only rebuild the variables that grew
        new_spatial = {}
        for name in self.variables:
            sp = self.spatial_index(name)
            payload = sp.to_json()
            payload["n"] = sp.n
            new_spatial[name] = payload
        self.spatial = new_spatial
        payload = {
            "version": INDEX_VERSION,
            "generation": int(self.generation),
            "variables": self.variables,
            "num_subfiles": self.num_subfiles,
            "attrs": self.attrs,
            "chunks": [c.to_json() for c in self.chunks],
            "spatial": self.spatial,
        }
        tmp = os.path.join(dirpath, INDEX_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(dirpath, INDEX_NAME))

    @staticmethod
    def load(dirpath: str) -> "DatasetIndex":
        with open(os.path.join(dirpath, INDEX_NAME)) as f:
            payload = json.load(f)
        version = payload.get("version", 1)
        if version not in SUPPORTED_INDEX_VERSIONS:
            raise ValueError(
                f"unsupported index version {version!r} in {dirpath} "
                f"(this reader understands {SUPPORTED_INDEX_VERSIONS})")
        idx = DatasetIndex(variables=payload["variables"],
                           num_subfiles=payload["num_subfiles"],
                           attrs=payload.get("attrs", {}),
                           spatial=payload.get("spatial", {}),
                           generation=int(payload.get("generation", 0)))
        idx.chunks = [ChunkRecord.from_json(c) for c in payload["chunks"]]
        return idx
