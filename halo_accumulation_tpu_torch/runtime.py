"""Device selection and the nvcc build of the CUDA kernels.

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

import hashlib
import os
import pathlib
import shutil
import subprocess

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
