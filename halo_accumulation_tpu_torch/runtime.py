"""Device selection, the nvcc build of the CUDA kernels, and the graph
cache (`graphed`), the port's counterpart of the JAX package's cached_jit.

There is no global backend switch: every entry point takes a `device`, and
`device()` only turns a user's choice into a torch.device.  The card is the
default: no choice means "cuda", which raises without a card; the CPU runs
only when a caller names it.

Kernels are plain-C-interface shared libraries: each `csrc/<name>.cu` is
compiled by nvcc for sm_90a into `build/kernels/<name>-<hash>.so` at first
use, all sources in parallel (`ops/cuda_kernels.py` names them and loads
the libraries with ctypes).  The hash covers the kernel's source and the
shared headers, so an edit rebuilds and an unchanged tree reuses the build.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from collections import OrderedDict
from dataclasses import dataclass

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
# -Xptxas -v: ptxas reports each function's registers and spills into the
# build log kept beside the library (build_log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def device(name: str | torch.device | None = None) -> torch.device:
    """torch.device for a user's choice: None or 'cuda' (raises without a
    card), or an explicit 'cpu'."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return dev


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names) -> dict[str, pathlib.Path]:
    """Compile every missing kernel library, one nvcc per source, all
    started together, keeping each compiler output as its build log.
    Returns {name: .so path}; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
            continue
        paths[n].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """The compiler output (ptxas's -v report) of kernel `name`'s current
    build."""
    return _lib_path(name).with_suffix(".log").read_text()


# -- captured CUDA graphs: the port's counterpart of the JAX package's cached_jit --

GRAPH_KEYS_MAX = 16  # graphs kept; a new key past it drops the least recently used


@dataclass
class Graph:
    """One captured body: its static input and output tensors, the kernel
    launches a replay makes (cuda_kernels.launches_since at capture), the
    objects it reads in place and the seconds its warm-up and capture took."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    output: torch.Tensor
    launches: dict
    holds: tuple
    capture_s: float


graphs: OrderedDict = OrderedDict()  # graph_key -> Graph, least recently used first
_graph_pool = None  # one memory pool that every graph allocates from
_warmup_stream = None
_eager = 0


def graph_key(name: str, shape_key: tuple, holds: tuple = ()) -> tuple:
    """A graph's key: its body's name, the static shapes it is captured at,
    and the identity of each object whose tensors it reads in place."""
    return (name, shape_key, tuple(id(h) for h in holds))


@contextlib.contextmanager
def _eager_graphs():
    """Run every graphed body eagerly in the block, as on the CPU: the
    comparison that chip_smoke.py and the tests make against the graphs."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


def graphed(name: str, shape_key: tuple, body, args, device, holds: tuple = ()):
    """body(*args) on `device`: on the card, a replay of a CUDA graph of
    body captured once per graph_key(name, shape_key, holds).

    body takes tensors and returns one tensor, and must not synchronize
    with the host (a capture refuses it).  On the CPU, and inside
    _eager_graphs(), body runs eagerly on args moved to `device`.  On the
    card the first call of a key warms body up once, eagerly on a side
    stream (that run loads the kernels and makes every cached device
    constant, and is the call's result), then captures it; a failed
    capture raises RuntimeError naming the key, and never falls back to the
    eager path.  Later calls copy args into the static inputs (a host
    tensor in args makes that copy the host-to-device one), replay, add
    the launches recorded at capture to cuda_kernels' counts, and return a
    clone of the static output, so a result survives later replays.

    Memory: every graph allocates from one shared pool, so the cache holds
    about the largest graph's working memory, not the sum; sharing is safe
    because replays run one at a time on the current stream and each
    output is cloned before anything else can replay.  At most
    GRAPH_KEYS_MAX graphs are kept, the least recently used dropped first."""
    dev = torch.device(device)
    if dev.type != "cuda" or _eager:
        return body(*(a.to(dev) for a in args))
    key = graph_key(name, shape_key, holds)
    g = graphs.get(key)
    if g is None:
        return _capture(key, body, args, dev, holds)
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    graphs.move_to_end(key)
    for s, a in zip(g.inputs, args):
        s.copy_(a)
    g.graph.replay()
    ck.add_launches(g.launches)
    return g.output.clone()


def _capture(key, body, args, dev, holds):
    """Warm-up, then capture; returns the warm-up's result."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    global _graph_pool, _warmup_stream
    if _graph_pool is None:
        _graph_pool = torch.cuda.graph_pool_handle()
        _warmup_stream = torch.cuda.Stream(dev)
    t = time.perf_counter()
    inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev).copy_(a) for a in args]
    current = torch.cuda.current_stream(dev)
    _warmup_stream.wait_stream(current)
    with torch.cuda.stream(_warmup_stream):
        out = body(*inputs)
    current.wait_stream(_warmup_stream)
    mark = ck.launch_record()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=_graph_pool):
            output = body(*inputs)
    except RuntimeError as e:
        raise RuntimeError(f"CUDA graph capture of {key} failed: {e}") from e
    finally:
        launches = ck.launches_since(mark)
        ck.restore_launches(mark)  # a capture records its launches, it runs none
    graphs[key] = Graph(graph, inputs, output, launches, holds, time.perf_counter() - t)
    while len(graphs) > GRAPH_KEYS_MAX:
        graphs.popitem(last=False)
    return out
