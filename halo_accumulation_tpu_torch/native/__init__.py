"""ctypes binding of the port's native CPU backend (`halo_native.cpp`).

The port's own copy of the JAX package's native backend, with the same six
entry points and byte layouts: `msm`, `scalar_mul`, `point_add`, `urs`,
`sha3` and `available`.  Scalars and coordinates cross the C ABI as 32-byte
little-endian canonical ints, a point as x || y with (0, 0) for the
identity.

The library is built at first use with g++ into
`build/native/halo_native-<hash>.so` beside the package (the hash covers
the source, the flags and the building machine's CPU model and flags, so
an edit rebuilds, an unchanged tree reuses the build, and a library built
with -march=native for another CPU is never loaded); a failed build raises
with g++'s output.  `available()` is
False only where there is no g++: the protocol then runs on the
pure-Python oracle (`fields.py`), which stays the reference the backend is
held to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import time

_SRC = pathlib.Path(__file__).resolve().parent / "halo_native.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
build_s = None  # seconds the g++ build took in this process (None: reused or not built)


def _cpu_id() -> bytes:
    """This machine's CPU model and instruction-set flags, which
    -march=native ties the library to (/proc/cpuinfo; the architecture name
    where that cannot be read)."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.split(":")[0].strip() in ("model name", "flags")]
    return "\n".join(dict.fromkeys(keep)).encode()


def lib_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_id())
    return BUILD_DIR / f"halo_native-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless this source's build exists; raises
    RuntimeError with g++'s output when the build fails."""
    global build_s
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native backend needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    t = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {_SRC.name} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders each write their own tmp
    build_s = time.perf_counter() - t
    return path


def get_lib():
    """The bound library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.halo_msm.argtypes = [ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.halo_scalar_mul.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.halo_point_add.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.halo_sha3_256.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
        lib.halo_urs.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the backend can run here: False without g++; otherwise the
    library is built (or raises) and bound."""
    if _lib is None and not lib_path().exists() and shutil.which("g++") is None:
        return False
    get_lib()
    return True


def _pt_bytes(P) -> bytes:
    if P is None:
        return b"\x00" * 64
    return P[0].to_bytes(32, "little") + P[1].to_bytes(32, "little")


def _pt_from(b: bytes):
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:64], "little")
    if x == 0 and y == 0:
        return None
    return (x, y)


def msm(scalars, points):
    """Native Pippenger MSM over host ints: scalars list[int] (canonical,
    below r), points list[(x, y) | None]."""
    lib = get_lib()
    sb = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    pb = b"".join(_pt_bytes(P) for P in points)
    out = ctypes.create_string_buffer(64)
    lib.halo_msm(len(scalars), sb, pb, out)
    return _pt_from(out.raw)


def scalar_mul(k: int, P):
    """k P for a canonical scalar k (below r)."""
    lib = get_lib()
    out = ctypes.create_string_buffer(64)
    lib.halo_scalar_mul(_pt_bytes(P), int(k).to_bytes(32, "little"), out)
    return _pt_from(out.raw)


def point_add(P, Q):
    lib = get_lib()
    out = ctypes.create_string_buffer(64)
    lib.halo_point_add(_pt_bytes(P), _pt_bytes(Q), out)
    return _pt_from(out.raw)


def urs(start: int, n: int):
    """Generator points for URS indices [start, start + n) as (x, y) pairs."""
    lib = get_lib()
    out = ctypes.create_string_buffer(64 * n)
    lib.halo_urs(start, n, out)
    return [_pt_from(out.raw[64 * i : 64 * (i + 1)]) for i in range(n)]


def sha3(data: bytes) -> bytes:
    lib = get_lib()
    out = ctypes.create_string_buffer(32)
    lib.halo_sha3_256(data, len(data), out)
    return out.raw
