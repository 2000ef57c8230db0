"""LSQR's minor loop as a CUDA WHILE node: one CUDA graph a fused major
whose LSQR iterations stop where the JAX package's lax.while_loop stops.

The fused major loop (inversion/joint.py::FusedSolver) captures a major as
three torch graphs in one memory pool, on one stream, in this order:

    head  the major up to LSQR's first products and the carry's buffers
          (ops/lsqr.py's split form), the loop's first condition in a
          one-byte flag `go`, and the body counter `runs` zeroed
    body  one LSQR iteration on those buffers, the next condition in `go`
    tail  the rest of the major

WhileGraph joins them (csrc/graph_while.cu) into one parent graph,

    head -> set_condition -> WHILE { body -> set_condition } -> tail

instantiated once, and launches it once a major: the card runs the body
while `go` holds, at most max_iter times, with no read of the device by the
host, and `runs` holds the body's runs after each launch. It replaces no
Pallas kernel: the JAX package's fused program is one XLA program whose
LSQR is a lax.while_loop (tomofastx_tpu/ops/lsqr.py:107-161). Its plain
version is ops/lsqr.py::while_on_the_host, which reads the flag on the host
before each iteration; the CPU runs the unrolled loop instead (FusedSolver's
eager steps).

Nothing falls back: a torch without CUDAGraph(keep_graph=True) and
raw_cuda_graph(), or a CUDA that refuses a node of the body (a
conditional body takes kernel, memset, device-to-device copy, child-graph
and conditional nodes), raises with CUDA's error text.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tomofastx_tpu_torch.ops import _cuda_build

_NAME = "graph_while"
# cudaGraphSetConditional is a call of the device runtime: the source is
# compiled as relocatable device code and linked with it.
FLAGS = ("-rdc=true", "-lcudadevrt")


def build_library() -> tuple[str, str]:
    """Compile csrc/graph_while.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME, FLAGS)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_library()[0])
    entries = {
        "graph_while_build": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) + (ctypes.POINTER(ctypes.c_void_p),) * 2,
        "graph_while_launch": (ctypes.c_void_p,) * 2,
        "graph_while_destroy": (ctypes.c_void_p,) * 2,
    }
    for name, argtypes in entries.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    lib.graph_while_error.argtypes = [ctypes.c_int]
    lib.graph_while_error.restype = ctypes.c_char_p
    return lib


def _check(lib, entry, err):
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({lib.graph_while_error(err).decode()})")


class WhileGraph:
    """head -> WHILE (go and runs < max_iter) { body } -> tail as one
    instantiated CUDA graph. head, body and tail are captured
    torch.cuda.CUDAGraph(keep_graph=True), whose memory pool holds the
    addresses the parent's nodes use: they are kept, with `keep` (whatever
    else the body reads), until close(), which frees the parent first."""

    def __init__(self, head, body, tail, go: torch.Tensor, runs: torch.Tensor, max_iter: int, keep=()):
        if go.dtype != torch.bool or go.dim() != 0 or runs.dtype != torch.int32 or runs.dim() != 0:
            raise ValueError(f"go must be a 0-dim bool tensor and runs a 0-dim int32 one, got {go.dtype} "
                             f"{tuple(go.shape)} and {runs.dtype} {tuple(runs.shape)}")
        if go.device.type != "cuda" or runs.device != go.device:
            raise ValueError(f"go and runs must lie on one CUDA device, got {go.device} and {runs.device}")
        raw = [g.raw_cuda_graph() for g in (head, body, tail)]
        lib = _library()
        parent, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(go.device):
            _check(lib, "graph_while_build", lib.graph_while_build(
                *raw, go.data_ptr(), runs.data_ptr(), int(max_iter), ctypes.byref(parent), ctypes.byref(exec_)))
        self._parent, self._exec = parent.value, exec_.value
        self.graphs, self.go, self.runs, self.max_iter, self.keep = (head, body, tail), go, runs, int(max_iter), keep

    def close(self):
        """Frees the instantiated graph and the parent, then lets go of the
        torch graphs (and their pool)."""
        if self._exec is not None:
            lib = _library()
            with torch.cuda.device(self.go.device):
                err = lib.graph_while_destroy(self._parent, self._exec)
            self._parent = self._exec = None
            self.graphs = self.keep = None
            _check(lib, "graph_while_destroy", err)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # nothing to raise to while being collected


def while_graph_launch(graph: WhileGraph):
    """One launch of the graph on the current stream: one major."""
    if graph._exec is None:
        raise RuntimeError("the graph was closed")
    lib = _library()
    with torch.cuda.device(graph.go.device):
        _check(lib, "graph_while_launch",
               lib.graph_while_launch(graph._exec, torch.cuda.current_stream(graph.go.device).cuda_stream))
    while_graph_launch.launches += 1


while_graph_launch.launches = 0
