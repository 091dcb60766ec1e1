"""Per-chunk compression codecs: the registry the container shares.

A copy of the JAX package's registry, kept byte-for-byte compatible so a
dataset written by either package decodes under the other:

* the **format** (``repro_torch.io.format``, index v4) stores one codec
  name per chunk record and the stored-vs-logical byte sizes;
* the **engines** decode inside the execute path
  (:func:`repro_torch.io.engine.scatter_row`), so plans stay extent-shaped
  and every engine works unchanged.

Codecs operate on raw bytes over buffer-protocol views — no dtype
awareness, no framing: the chunk record already knows the logical size, so
the stream needs no header.  ``none`` and ``zlib`` are always available;
``lz4`` registers only when the container ships the module (no network
installs — an unavailable codec is *absent*, and loading an index that
names one fails loudly at decode time, never silently misreads bytes).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

__all__ = ["Codec", "CODECS", "CODEC_NONE", "codec_code", "codec_name",
           "get_codec", "available_codecs", "encode", "decode"]

#: numeric code of the identity codec — per-plan row arrays use these small
#: ints so the engine hot path tests ``code != CODEC_NONE`` on a numpy
#: array instead of comparing strings
CODEC_NONE = 0

#: zlib level used for chunk extents: level 1 trades a few percent of ratio
#: for ~3x the compress bandwidth — the lifecycle objective is seconds, not
#: bytes, and at higher levels the codec loses to the disk it is saving
ZLIB_LEVEL = 1


@dataclasses.dataclass(frozen=True)
class Codec:
    """One registered codec: raw ``compress``/``decompress`` over bytes."""

    name: str
    code: int                          # stable small int for plan arrays
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


def _zlib_compress(buf) -> bytes:
    return zlib.compress(bytes(memoryview(buf).cast("B")), ZLIB_LEVEL)


def _zlib_decompress(buf) -> bytes:
    return zlib.decompress(bytes(memoryview(buf).cast("B")))


def _identity(buf) -> bytes:
    return bytes(memoryview(buf).cast("B"))


#: name -> Codec.  Codes are stable across processes (they appear in plan
#: arrays, never on disk — the index stores the *name*).
CODECS: dict = {
    "none": Codec("none", CODEC_NONE, _identity, _identity),
    "zlib": Codec("zlib", 1, _zlib_compress, _zlib_decompress),
}

try:                                    # pragma: no cover - container-dependent
    import lz4.block as _lz4block

    def _lz4_compress(buf) -> bytes:
        return _lz4block.compress(bytes(memoryview(buf).cast("B")),
                                  store_size=False)

    def _lz4_decompress_sized(buf, size: int) -> bytes:
        return _lz4block.decompress(bytes(memoryview(buf).cast("B")),
                                    uncompressed_size=size)

    CODECS["lz4"] = Codec("lz4", 2, _lz4_compress, None)
except ImportError:                     # lz4 is optional by design
    _lz4_decompress_sized = None

_BY_CODE = {c.code: c for c in CODECS.values()}


def available_codecs() -> tuple:
    """Registered codec names, ``none`` first (stable order)."""
    return tuple(sorted(CODECS, key=lambda n: CODECS[n].code))


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r} (available: "
            f"{', '.join(available_codecs())}; 'lz4' needs the lz4 module)"
        ) from None


def codec_code(name: str) -> int:
    """The stable small-int code of ``name`` (for per-row plan arrays)."""
    return get_codec(name).code


def codec_name(code: int) -> str:
    try:
        return _BY_CODE[code].name
    except KeyError:
        raise ValueError(f"unknown codec code {code!r}") from None


def encode(name: str, buf) -> bytes:
    """Compress one extent's bytes (identity for ``none``)."""
    return get_codec(name).compress(buf)


def decode(name_or_code, buf, logical_nbytes: int) -> bytes:
    """Decompress one stored extent back to its logical bytes.

    ``logical_nbytes`` is the expected decoded size from the chunk record —
    a mismatch means a torn or misattributed extent and raises, the same
    fail-loudly discipline as the CRC validation path.
    """
    codec = _BY_CODE[name_or_code] if isinstance(name_or_code, int) \
        else get_codec(name_or_code)
    if codec.code == CODEC_NONE:
        out = bytes(memoryview(buf).cast("B"))
    elif codec.name == "lz4":           # pragma: no cover - container-dep.
        out = _lz4_decompress_sized(buf, logical_nbytes)
    else:
        out = codec.decompress(buf)
    if len(out) != logical_nbytes:
        raise ValueError(
            f"codec {codec.name!r}: decoded {len(out)} bytes, chunk record "
            f"says {logical_nbytes} — stored extent is torn or mislabeled")
    return out
