"""ctypes binding for the native table reader/writer (fasttab.cpp).

g++ compiles the shared library the first time a table is read or written
(never at import) into ``build/`` beside the package, as
ops/_cuda_build.py does for the CUDA sources: the library's name carries a
hash of the source, so an edited source is compiled again and nothing is
written next to the source. When it cannot be built or loaded, `lib()`
returns None, io/tableio.py takes the numpy path and `build_error()` says
why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fasttab.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_HERE))), "build")

_lock = threading.Lock()
_lib = None
_error = None  # why the library is unavailable, once a build was tried


def library_path() -> str:
    """build/libfasttab_<hash of the source>.so."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfasttab_{tag}.so")


def _build(path: str) -> None:
    """Compile the source into `path` unless a library of this very source
    is there already. Raises RuntimeError with the compiler's output."""
    if os.path.exists(path):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}): {proc.stderr.strip()}")
    os.replace(tmp, path)


def lib():
    """The loaded CDLL, or None when the library cannot be built or loaded
    (build_error() then says why). Tried once per process."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = library_path()
            _build(path)
            lb = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        lb.ft_parse_file.restype = ctypes.POINTER(ctypes.c_double)
        lb.ft_parse_file.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lb.ft_free.restype = None
        lb.ft_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lb.ft_write_table.restype = ctypes.c_int
        lb.ft_write_table.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_long, ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lb
        return _lib


def build_error():
    """Why the library is unavailable (None when it loaded or was not tried)."""
    return _error
