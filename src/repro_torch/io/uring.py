"""Raw ``io_uring`` ring wrapper — ctypes + mmap, no liburing (a copy of the
JAX package's module).

:class:`IoUring` owns one submission/completion ring pair obtained straight
from the three ``io_uring`` syscalls (``setup``/``enter``/``register``) and
exposes exactly what :class:`~repro_torch.io.engine.UringEngine` needs: prep a
read/write SQE, batched submit, drain CQEs, register a fixed-buffer pool
for zero-copy gathers.  It knows nothing about plans, datasets or numpy —
callers hand in raw addresses (``ndarray.ctypes.data``) and keep the
backing memory alive until the matching CQE is reaped.

Feature detection is end-to-end: :func:`uring_available` builds a real ring
and round-trips an ``IORING_OP_READ`` against a scratch file, so kernels
that have the syscalls but predate the opcode (< 5.6), seccomp filters
that block them, and ``kernel.io_uring_disabled`` sysctls all report as a
single ``(False, reason)`` — the engine layer degrades to ``overlapped``
on that signal and records why.

This module is import-safe everywhere: nothing touches the kernel until a
ring is constructed or the probe is called.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import tempfile
import threading

__all__ = ["IoUring", "UringUnavailable", "uring_available",
           "OP_READ", "OP_WRITE", "OP_READ_FIXED", "OP_WRITE_FIXED"]

# x86_64 / aarch64 share these numbers (unified syscall table since 5.1)
_NR_SETUP, _NR_ENTER, _NR_REGISTER = 425, 426, 427

_OFF_SQ_RING = 0
_OFF_CQ_RING = 0x8000000
_OFF_SQES = 0x10000000

_FEAT_SINGLE_MMAP = 1
_ENTER_GETEVENTS = 1
_REGISTER_BUFFERS = 0
_UNREGISTER_BUFFERS = 1

#: opcodes the engine uses (IORING_OP_*)
OP_READV, OP_WRITEV = 1, 2
OP_READ_FIXED, OP_WRITE_FIXED = 4, 5
OP_READ, OP_WRITE = 22, 23          # kernel >= 5.6

_SQE_BYTES = 64
_CQE_BYTES = 16
#: little-endian SQE: opcode,flags,ioprio,fd, off, addr, len,rw_flags,
#: user_data, buf_index,personality,splice_fd_in, pad[2]
_SQE_FMT = "<BBHiQQIIQHHiQQ"
_CQE_FMT = "<QiI"


class UringUnavailable(OSError):
    """io_uring cannot be used here (kernel, seccomp, sysctl or rlimit)."""


class _SQOff(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "flags",
                 "dropped", "array", "resv1")] + \
               [("user_addr", ctypes.c_uint64)]


class _CQOff(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "overflow",
                 "cqes", "flags", "resv1")] + \
               [("user_addr", ctypes.c_uint64)]


class _Params(ctypes.Structure):
    _fields_ = [("sq_entries", ctypes.c_uint32),
                ("cq_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("sq_thread_cpu", ctypes.c_uint32),
                ("sq_thread_idle", ctypes.c_uint32),
                ("features", ctypes.c_uint32),
                ("wq_fd", ctypes.c_uint32),
                ("resv", ctypes.c_uint32 * 3),
                ("sq_off", _SQOff),
                ("cq_off", _CQOff)]


class _IOVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        lib = ctypes.CDLL(None, use_errno=True)
        lib.syscall.restype = ctypes.c_long
        _libc = lib
    return _libc


class IoUring:
    """One io_uring instance: SQ + CQ rings and the SQE array, mmapped.

    Single-submitter: one thread preps and submits at a time (the engine
    serializes on its own lock).  The kernel is the only other party
    touching the rings, and the ``io_uring_enter`` syscall on submit /
    reap provides the ordering the shared ring head/tail indices need.
    """

    def __init__(self, entries: int = 64):
        lib = _get_libc()
        p = _Params()
        fd = lib.syscall(_NR_SETUP, ctypes.c_uint(entries), ctypes.byref(p))
        if fd < 0:
            err = ctypes.get_errno()
            raise UringUnavailable(
                err, f"io_uring_setup failed: {os.strerror(err)}")
        self.ring_fd = int(fd)
        self.sq_entries = int(p.sq_entries)
        self.cq_entries = int(p.cq_entries)
        try:
            sq_sz = p.sq_off.array + p.sq_entries * 4
            cq_sz = p.cq_off.cqes + p.cq_entries * _CQE_BYTES
            if p.features & _FEAT_SINGLE_MMAP:
                self._sq_mm = mmap.mmap(self.ring_fd, max(sq_sz, cq_sz),
                                        offset=_OFF_SQ_RING)
                self._cq_mm = self._sq_mm
            else:                       # pragma: no cover - pre-5.4 kernels
                self._sq_mm = mmap.mmap(self.ring_fd, sq_sz,
                                        offset=_OFF_SQ_RING)
                self._cq_mm = mmap.mmap(self.ring_fd, cq_sz,
                                        offset=_OFF_CQ_RING)
            self._sqes = mmap.mmap(self.ring_fd, p.sq_entries * _SQE_BYTES,
                                   offset=_OFF_SQES)
        except OSError as e:            # pragma: no cover - mmap refusal
            os.close(self.ring_fd)
            raise UringUnavailable(f"io_uring ring mmap failed: {e}") from e
        self._sq_head_off = p.sq_off.head
        self._sq_tail_off = p.sq_off.tail
        self._sq_array_off = p.sq_off.array
        self._sq_mask = struct.unpack_from(
            "<I", self._sq_mm, p.sq_off.ring_mask)[0]
        self._cq_head_off = p.cq_off.head
        self._cq_tail_off = p.cq_off.tail
        self._cqes_off = p.cq_off.cqes
        self._cq_mask = struct.unpack_from(
            "<I", self._cq_mm, p.cq_off.ring_mask)[0]
        self._tail = struct.unpack_from("<I", self._sq_mm,
                                        self._sq_tail_off)[0]
        self._registered = False
        self._reg_keepalive = None      # buffers pinned for DMA
        self._closed = False

    # -- registered fixed buffers -------------------------------------------
    def register_buffers(self, buffers) -> None:
        """Register ``buffers`` (objects with ``.ctypes.data``/``.nbytes``)
        as the fixed-buffer table; raises ``UringUnavailable`` when the
        kernel refuses (typically ``RLIMIT_MEMLOCK``)."""
        iov = (_IOVec * len(buffers))()
        for i, b in enumerate(buffers):
            iov[i].iov_base = b.ctypes.data
            iov[i].iov_len = b.nbytes
        r = _get_libc().syscall(_NR_REGISTER, ctypes.c_uint(self.ring_fd),
                                ctypes.c_uint(_REGISTER_BUFFERS),
                                ctypes.byref(iov), ctypes.c_uint(len(iov)))
        if r < 0:
            err = ctypes.get_errno()
            raise UringUnavailable(
                err, f"buffer registration failed: {os.strerror(err)}")
        self._registered = True
        self._reg_keepalive = tuple(buffers)

    # -- submission ----------------------------------------------------------
    def sq_space(self) -> int:
        head = struct.unpack_from("<I", self._sq_mm, self._sq_head_off)[0]
        return self.sq_entries - ((self._tail - head) & 0xFFFFFFFF)

    def prep(self, opcode: int, fd: int, addr: int, nbytes: int,
             offset: int, user_data: int, buf_index: int = 0) -> None:
        """Write one SQE at the local tail (caller checked ``sq_space``)."""
        idx = self._tail & self._sq_mask
        struct.pack_into(_SQE_FMT, self._sqes, idx * _SQE_BYTES,
                         opcode, 0, 0, fd, offset, addr, nbytes, 0,
                         user_data, buf_index, 0, 0, 0, 0)
        struct.pack_into("<I", self._sq_mm,
                         self._sq_array_off + idx * 4, idx)
        self._tail = (self._tail + 1) & 0xFFFFFFFF
        struct.pack_into("<I", self._sq_mm, self._sq_tail_off, self._tail)

    def submit(self, to_submit: int, wait_for: int = 0) -> int:
        """``io_uring_enter``: submit ``to_submit`` queued SQEs and block
        until ``wait_for`` completions are available."""
        lib = _get_libc()
        while True:
            r = lib.syscall(_NR_ENTER, ctypes.c_uint(self.ring_fd),
                            ctypes.c_uint(to_submit),
                            ctypes.c_uint(wait_for),
                            ctypes.c_uint(_ENTER_GETEVENTS if wait_for
                                          else 0),
                            None, ctypes.c_size_t(0))
            if r >= 0:
                return int(r)
            err = ctypes.get_errno()
            if err == 4:                # EINTR: retry the wait
                to_submit = 0
                continue
            raise OSError(err, f"io_uring_enter: {os.strerror(err)}")

    def reap(self) -> list:
        """Drain available CQEs -> ``[(user_data, res), ...]``."""
        out = []
        head = struct.unpack_from("<I", self._cq_mm, self._cq_head_off)[0]
        tail = struct.unpack_from("<I", self._cq_mm, self._cq_tail_off)[0]
        while head != tail:
            idx = head & self._cq_mask
            ud, res, _flags = struct.unpack_from(
                _CQE_FMT, self._cq_mm, self._cqes_off + idx * _CQE_BYTES)
            out.append((ud, res))
            head = (head + 1) & 0xFFFFFFFF
        struct.pack_into("<I", self._cq_mm, self._cq_head_off, head)
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sqes.close()
            if self._cq_mm is not self._sq_mm:  # pragma: no cover
                self._cq_mm.close()
            self._sq_mm.close()
        finally:
            os.close(self.ring_fd)
        self._reg_keepalive = None

    def __del__(self):                  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# feature probe
# ---------------------------------------------------------------------------

_probe_lock = threading.Lock()
_probe_result: tuple | None = None


def _probe() -> tuple:
    try:
        ring = IoUring(entries=4)
    except UringUnavailable as e:
        return False, str(e)
    try:
        fd = -1
        path = None
        try:
            fd, path = tempfile.mkstemp(prefix="uring_probe_")
            os.write(fd, b"\xa5" * 4096)
            import numpy as np
            buf = np.zeros(4096, dtype=np.uint8)
            ring.prep(OP_READ, fd, buf.ctypes.data, 4096, 0, user_data=7)
            ring.submit(1, wait_for=1)
            cqes = ring.reap()
            if len(cqes) != 1 or cqes[0][0] != 7:
                return False, "io_uring probe: completion mismatch"
            res = cqes[0][1]
            if res < 0:
                return False, ("io_uring probe: IORING_OP_READ -> "
                               f"{os.strerror(-res)} (kernel < 5.6?)")
            if res != 4096 or not (buf == 0xA5).all():
                return False, "io_uring probe: data mismatch"
            return True, ""
        finally:
            if fd >= 0:
                os.close(fd)
            if path is not None:
                os.unlink(path)
    except Exception as e:              # pragma: no cover - defensive
        return False, f"io_uring probe failed: {e}"
    finally:
        ring.close()


def uring_available() -> tuple:
    """``(supported, reason)`` — cached once per process.  ``reason`` is
    the human-readable explanation that lands in ``engine_reason`` when
    the uring engine falls back."""
    global _probe_result
    if _probe_result is None:
        with _probe_lock:
            if _probe_result is None:
                _probe_result = _probe()
    return _probe_result
