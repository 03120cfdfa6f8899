"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, into an object for ``sm_90a``; the objects link into
one shared library with a plain C interface.  The library lands in
``ops/kernels/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so a checkout builds once and a source
edit rebuilds.  Nothing is built at import time: the first call of
:func:`library` builds (on the machine with the card), and a missing
``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_build"
LIB_NAME = "libmlt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_c_void = ctypes.c_void_p
_c_int = ctypes.c_int


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's kernels build from "
            "ops/kernels/csrc/ on a machine with the CUDA toolkit")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if not already built) and return the library's path.

    ``verbose`` prints ptxas's per-kernel register / shared-memory /
    spill report of a fresh build."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {src.name} ---\n{log}")
            elif verbose:
                print(f"--- nvcc {src.name} ---\n{log}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            # every entry point ends with (device index, stream)
            tail = [_c_int, _c_void]
            # q, k_pool, v_pool, tables, table_index, positions, horizons,
            # out; R, n, nkv, d, W, page, pages, scale, window, seg_stages,
            # segs, slots; the plan, (m, l) and O; dtype, path
            lib.paged_ragged_launch.argtypes = (
                [_c_void] * 8 + [_c_int] * 7 + [ctypes.c_float]
                + [_c_int] * 4 + [_c_void] * 3 + [_c_int] * 2 + tail)
            lib.paged_ragged_launch.restype = _c_int
            # q, k_pool, v_pool, block_tables, positions, out; b, n, nkv, d,
            # W, page, pages, scale, window, seg_stages, segs, slots; the
            # plan, (m, l) and O; dtype, path
            lib.paged_decode_launch.argtypes = (
                [_c_void] * 6 + [_c_int] * 7 + [ctypes.c_float]
                + [_c_int] * 4 + [_c_void] * 3 + [_c_int] * 2 + tail)
            lib.paged_decode_launch.restype = _c_int
            # q, k_pool, v_pool, block_tables, start, out; b, s, n, nkv, d,
            # kv_pages, page, pages, scale, window, seg_stages, segs, dtype,
            # path
            lib.paged_prefill_launch.argtypes = (
                [_c_void] * 6 + [_c_int] * 8 + [ctypes.c_float]
                + [_c_int] * 5 + tail)
            lib.paged_prefill_launch.restype = _c_int
            lib.paged_error_string.argtypes = [_c_int]
            lib.paged_error_string.restype = ctypes.c_char_p
            # tensor pointers, the host arrays of element strides and of
            # TMA geometry, the device tile counter, then b, sq, skv, n,
            # nkv, d, scale, causal, window, dtype, out_f32, path
            dims = [_c_int] * 6 + [ctypes.c_float] + [_c_int] * 5
            for name, n_ptrs in (("flash_fwd_launch", 7),
                                 ("flash_bwd_dq_launch", 9),
                                 ("flash_bwd_dkv_launch", 10)):
                fn = getattr(lib, name)
                fn.argtypes = [_c_void] * (n_ptrs + 3) + dims + tail
                fn.restype = _c_int
            # x, w, y; rows, h, eps, x dtype, w dtype
            lib.rms_norm_fwd_launch.argtypes = (
                [_c_void] * 3 + [_c_int] * 2 + [ctypes.c_float]
                + [_c_int] * 2 + tail)
            lib.rms_norm_fwd_launch.restype = _c_int
            # x, w, g, dx, dw, workspace; rows, h, rows a block, eps,
            # x dtype, w dtype
            lib.rms_norm_bwd_launch.argtypes = (
                [_c_void] * 6 + [_c_int] * 3 + [ctypes.c_float]
                + [_c_int] * 2 + tail)
            lib.rms_norm_bwd_launch.restype = _c_int
            _lib = lib
        return _lib
