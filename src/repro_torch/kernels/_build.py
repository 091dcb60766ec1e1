"""Build the port's CUDA kernels from the repository's sources at first use,
and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  All sources build at once, one ``nvcc`` each, in parallel.
Libraries land in ``build/repro_torch_kernels/<digest>/`` under the
repository root; the digest covers the sources and the flags, so an edited
source builds afresh and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is looked for only when a kernel is first launched on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "check", "count"]

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float

_FLASH_FWD_SM90 = (_P,) * 5 + (_LL,) * 15 + (_I, _I, _LL, _I, _F, _F, _P)
_FLASH_BWD = (_LL,) * 18 + (_I, _I, _I, _LL, _I, _F, _F, _P)
_FLASH_BWD_SM90 = (_LL,) * 18 + (_I, _I, _LL, _I, _F, _F, _P)

#: library name -> {C entry point: its argument types}
SOURCES = {
    "pack_rows": {"repro_pack_rows": (_P, _P, _P, _P, _LL, _LL, _P)},
    "relayout": {"repro_relayout": (_P, _P, _LL, _LL, _LL, _LL, _I, _P)},
    "flash_fwd": {"repro_flash_fwd": (_P,) * 5 + (_LL,) * 15
                  + (_I, _I, _I, _LL, _I, _F, _F, _P)},
    "flash_fwd_sm90": {"repro_flash_fwd_sm90": _FLASH_FWD_SM90},
    "flash_fwd_sm90_d256": {"repro_flash_fwd_sm90_d256": _FLASH_FWD_SM90},
    "flash_fwd_f32tc": {"repro_flash_fwd_f32tc": _FLASH_FWD_SM90},
    "flash_bwd": {"repro_flash_dq": (_P,) * 7 + _FLASH_BWD,
                  "repro_flash_dkv": (_P,) * 8 + _FLASH_BWD},
    "flash_bwd_sm90": {"repro_flash_dq_sm90": (_P,) * 7 + _FLASH_BWD_SM90,
                       "repro_flash_dkv_sm90": (_P,) * 8 + _FLASH_BWD_SM90},
    "flash_bwd_sm90_d256": {
        "repro_flash_dq_sm90_d256": (_P,) * 7 + _FLASH_BWD_SM90,
        "repro_flash_dkv_sm90_d256": (_P,) * 8 + _FLASH_BWD_SM90},
    "flash_bwd_f32tc": {"repro_flash_dq_f32tc": (_P,) * 7 + _FLASH_BWD_SM90,
                        "repro_flash_dkv_f32tc": (_P,) * 8 + _FLASH_BWD_SM90},
}

_lock = threading.Lock()
_libs: dict = {}
_count_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Build every missing library, all ``nvcc`` processes started together.

    Returns ``{name: {"path", "seconds", "log"}}``: ``log`` is the
    compiler's output (``ptxas -v``'s report), kept beside the library, and
    ``seconds`` 0.0 for a library that was already built.  Raises with the
    compiler's output if any build fails.
    """
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    info = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        info[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
        if lib.exists():
            saved = out_dir / f"lib{name}.log"
            info[name]["log"] = saved.read_text() if saved.exists() else ""
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        info[name]["seconds"] = time.perf_counter() - t0
        info[name]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        (out_dir / f"lib{name}.log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with its entry
    points' argument and return types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name]["path"])
            for entry, argtypes in SOURCES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")


def count(counter) -> None:
    """Add one to ``counter.launches`` (a wrapper, or one flash kernel's
    counter) under a lock, so no launch from a staging worker's thread is
    lost."""
    with _count_lock:
        counter.launches += 1
