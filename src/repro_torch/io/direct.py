"""``O_DIRECT`` helpers — aligned buffers and libc pread/pwrite (a copy of
the JAX package's module).

``O_DIRECT`` transfers DMA straight between the device and user memory,
skipping the page cache — but the kernel requires the file offset, the
transfer length *and* the user buffer address to be aligned (logical block
size; 4096 covers every filesystem we target).  CPython's ``os.pread``
cannot honor the address constraint (it reads into an internal bytes
object at an arbitrary address), so direct transfers go through libc's
``pread``/``pwrite`` via ctypes against numpy buffers carved out at a
4096-aligned address by :func:`aligned_empty`.

Support is a per-filesystem property (tmpfs refuses ``O_DIRECT`` with
``EINVAL`` at open; ext4/xfs and parallel filesystems accept it), so
:func:`odirect_available` probes per directory and caches by device id.
"""

from __future__ import annotations

import ctypes
import errno
import os
import threading

import numpy as np

__all__ = ["DIRECT_ALIGN", "aligned_empty", "open_direct",
           "pread_into_direct", "pwrite_direct", "odirect_available"]

#: one alignment for offset, length and address — 4096 is the logical
#: block size of every filesystem this repo targets (GPFS_BLOCK is a
#: multiple); statx(STATX_DIOALIGN) could shrink it but gains little
DIRECT_ALIGN = 4096

_O_DIRECT = getattr(os, "O_DIRECT", 0x4000)   # linux x86_64/aarch64 value

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        lib = ctypes.CDLL(None, use_errno=True)
        lib.pread.restype = ctypes.c_ssize_t
        lib.pread.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_size_t, ctypes.c_int64]
        lib.pwrite.restype = ctypes.c_ssize_t
        lib.pwrite.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_size_t, ctypes.c_int64]
        _libc = lib
    return _libc


def aligned_empty(nbytes: int, align: int = DIRECT_ALIGN) -> np.ndarray:
    """A ``uint8`` buffer of ``nbytes`` whose data pointer is
    ``align``-aligned (over-allocate, slice at the aligned offset)."""
    raw = np.empty(nbytes + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes]


def open_direct(path: str, writable: bool = False) -> int:
    """Open ``path`` with ``O_DIRECT``; raises ``OSError`` (``EINVAL``)
    where the filesystem refuses direct I/O — callers fall back."""
    flags = (os.O_RDWR | os.O_CREAT) if writable else os.O_RDONLY
    return os.open(path, flags | _O_DIRECT)


def pread_into_direct(fd: int, buf: np.ndarray, offset: int) -> int:
    """Direct ``pread`` into an aligned buffer; returns bytes read (may be
    short only at EOF — a direct read past the data stops at the file
    size).  ``buf``'s address, ``offset`` and ``len(buf)`` must all be
    ``DIRECT_ALIGN``-aligned."""
    lib = _get_libc()
    base = buf.ctypes.data
    done, want = 0, buf.nbytes
    while done < want:
        n = lib.pread(fd, ctypes.c_void_p(base + done), want - done,
                      offset + done)
        if n < 0:
            err = ctypes.get_errno()
            if err == errno.EINTR:
                continue
            raise OSError(err, f"direct pread: {os.strerror(err)}")
        if n == 0:                      # EOF inside the aligned window
            break
        done += n
    return done


def pwrite_direct(fd: int, buf: np.ndarray, offset: int) -> None:
    """Direct ``pwrite`` of the whole aligned buffer (address, offset and
    length ``DIRECT_ALIGN``-aligned)."""
    lib = _get_libc()
    base = buf.ctypes.data
    done, want = 0, buf.nbytes
    while done < want:
        n = lib.pwrite(fd, ctypes.c_void_p(base + done), want - done,
                       offset + done)
        if n < 0:
            err = ctypes.get_errno()
            if err == errno.EINTR:
                continue
            raise OSError(err, f"direct pwrite: {os.strerror(err)}")
        done += n


# ---------------------------------------------------------------------------
# feature probe — per directory, cached by device id
# ---------------------------------------------------------------------------

_probe_lock = threading.Lock()
_probe_cache: dict = {}                 # st_dev -> (bool, reason)


def _probe_dir(dirpath: str) -> tuple:
    path = os.path.join(dirpath, f".odirect_probe.{os.getpid()}")
    try:
        payload = aligned_empty(DIRECT_ALIGN)
        payload[:] = 0x5A
        fd = open_direct(path, writable=True)
        try:
            pwrite_direct(fd, payload, 0)
            back = aligned_empty(DIRECT_ALIGN)
            got = pread_into_direct(fd, back, 0)
            if got != DIRECT_ALIGN or not (back == 0x5A).all():
                return False, "O_DIRECT probe: data mismatch"
        finally:
            os.close(fd)
        return True, ""
    except OSError as e:
        return False, f"O_DIRECT unsupported here: {e}"
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def odirect_available(dirpath: str) -> tuple:
    """``(supported, reason)`` for the filesystem holding ``dirpath`` —
    a real aligned write+read round trip, cached per device id."""
    try:
        dev = os.stat(dirpath).st_dev
    except OSError as e:
        return False, f"O_DIRECT probe: cannot stat {dirpath!r}: {e}"
    with _probe_lock:
        hit = _probe_cache.get(dev)
        if hit is None:
            hit = _probe_cache[dev] = _probe_dir(dirpath)
        return hit
