"""Building and loading the package's CUDA kernels.

Each kernel is one source under csrc/ with plain C entry points. nvcc
compiles it for sm_90a into a shared library in ``build/`` beside the
package, the first time a CUDA tensor reaches the kernel's wrapper (never at
import), and ctypes loads it. The library's name carries a hash of the
source and of the headers under csrc/ that it includes, so an edited source
or header is compiled again and an unchanged one is not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build")


def source_path(name: str) -> str:
    """Path of csrc/<name>.cu."""
    return os.path.join(_PACKAGE_DIR, "csrc", f"{name}.cu")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> list:
    """csrc/<name>.cu and every csrc/ header it includes with #include
    "...", directly or through another header, in the order first met."""
    files, todo = [], [source_path(name)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [os.path.join(os.path.dirname(path), h.decode()) for h in _LOCAL_INCLUDE.findall(f.read())]
    return files


def source_tag(name: str) -> str:
    """The hash that names the library of csrc/<name>.cu: of its source and
    of the headers it includes (source_files)."""
    h = hashlib.sha256()
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu for sm_90a into build/ unless a library of
    this very source and its headers is there already. Returns (path of the
    library, what the compiler printed, empty if nothing was compiled)."""
    source = source_path(name)
    path = os.path.join(BUILD_DIR, f"lib{name}_{source_tag(name)}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, source,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return path, log


@functools.lru_cache(maxsize=None)
def load_library(name: str, functions: tuple, argtypes: tuple):
    """Build (if need be) and load the library of csrc/<name>.cu, and declare
    each of `functions` as int f(*argtypes)."""
    path, _ = build_library(name)
    lib = ctypes.CDLL(path)
    for fn in functions:
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def float64_output(shape, like, out=None):
    """A contiguous float64 tensor of `shape` on `like`'s device for a
    kernel's float64 sums: `out` itself, checked, when given, else a new
    one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float64, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float64 or not out.is_contiguous() or (
            out.device != like.device):
        raise ValueError(f"the output must be a contiguous float64 {tuple(shape)} on {like.device}")
    return out


def require_launchable(**tensors):
    """The kernels read 16 bytes a lane from dense arrays: refuse a tensor
    that is not contiguous or whose storage is not 16-byte aligned."""
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# A blended matrix-free operator's stored near rows (ops/matrixfree.py
# near_row_layout): by observation (near_rptr, near_rcell, near_rval) and by
# cell (near_ccell, near_cptr, near_cobs, near_cval).
NEAR_ROW_FIELDS = ("near_rptr", "near_rcell", "near_rval", "near_ccell", "near_cptr", "near_cobs", "near_cval")

# Both near passes' entry points over the stored rows (csrc/prism_common.cuh
# near_stream_pass): nmc, ndc, lanes; the offsets, entries, rows and (by cell)
# the segments' cells; the segments; the input, the output; N; the stream.
NEAR_STREAM_ARGTYPES = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) + (ctypes.c_void_p,) * 2 + (
    ctypes.c_int, ctypes.c_void_p)


def stored_near_rows(op) -> tuple:
    """The stored near rows of `op`, NEAR_ROW_FIELDS in order."""
    return tuple(getattr(op, f) for f in NEAR_ROW_FIELDS)


def stored_near_rows_ok(op) -> bool:
    """Whether `op` holds its stored near rows as the near passes read
    them: int32 indices, float32 rows, and its groups of lanes."""
    rows = stored_near_rows(op)
    if any(a is None for a in rows) or getattr(op, "near_lanes", None) is None:
        return False
    return all(a.dtype == (torch.float32 if f.endswith("val") else torch.int32) for f, a in zip(NEAR_ROW_FIELDS, rows))


def near_stream(fn, entry, nmc, ndc, op, by_obs, vin, out, N):
    """One launch of a near pass over `op`'s stored rows (by observation, the
    matvec's, or by cell, the rmatvec's) from vin into out on the current
    stream; raises on a CUDA error."""
    if by_obs:
        ptr, idx, val, seg, lanes = op.near_rptr, op.near_rcell, op.near_rval, None, op.near_lanes[0]
    else:
        ptr, idx, val, seg, lanes = op.near_cptr, op.near_cobs, op.near_cval, op.near_ccell, op.near_lanes[1]
    with torch.cuda.device(vin.device):
        check(entry, fn(nmc, ndc, lanes, ptr.data_ptr(), idx.data_ptr(), val.data_ptr(),
                        None if seg is None else seg.data_ptr(), ptr.shape[0] - 1, vin.data_ptr(), out.data_ptr(), N,
                        torch.cuda.current_stream().cuda_stream))


def check(entry, err):
    """Raises unless a library entry point returned 0 (cudaSuccess)."""
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
