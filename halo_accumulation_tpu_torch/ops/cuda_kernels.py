"""The port's Hopper kernels: wrappers, launch counts and plain twins.

Five CUDA kernels (sources in `halo_accumulation_tpu_torch/csrc/`) replace
every Pallas kernel of `halo_accumulation_tpu/ops/pallas_kernels.py`, and
two more replace XLA glue of the JAX package that runs hot on the card
(no Pallas site):

  fmul           <- _fmul_kernel           Fq multiply (the others' inner loop)
  padd           <- _padd_kernel           complete projective add (a lane split across
                                           six threads)
  pdbl           <- _pdbl_kernel           k complete projective doubles per launch
  bucket_masked  <- _bucket_kernel_masked  masked bucket reduction, sort-payload MSM
                                           (a column split across T threads)
  bucket_accum   <- _bucket_kernel_aff /   pad-axis bucket sums, row-permutation MSM
                    _bucket_kernel_proj    (a column split across T threads)
  finv           <- Field.pow_const at     batched inversion by divsteps, Fq or Fr
                    Field.inv's root       (one lane a thread)
  rho_round      <- pcdl._rho_round_device a round's challenge: the SHA3-256 of
                    over ops/keccak.py     xi || L || R reduced mod r (one warp)

Each has a plain PyTorch twin here that runs the same field operations in
the same order (the twins run ops/limbs.py's list form stacked over a batch
axis, in the JAX package's lazy 15-bit limbs).  The kernels compute on
8 x 32-bit words (csrc/field.cuh) and store canonical limbs, so a kernel's
output equals FQ.canon of its twin's, limb for limb.  A wrapper takes the
twin for tensors on the CPU and launches the kernel for CUDA tensors; any
other device raises.  Each launch adds one to its kernel's `launches`
count and to its count at that width (`widths`), and only a launch does:
a call of width 0 has nothing to compute and launches nothing.  A replay
of a CUDA graph adds the launches its capture recorded (add_launches).
"""

from __future__ import annotations

import ctypes
import re
from collections import Counter
from collections.abc import Callable
from dataclasses import dataclass, field

import torch

from halo_accumulation_tpu_torch import runtime
from halo_accumulation_tpu_torch.ops import keccak
from halo_accumulation_tpu_torch.ops.field import FQ, FR, I64, L, W

B3 = 15  # 3 * b for y^2 = x^3 + 5
# Row-table widths of the row-permutation MSM (ops/msm.rows_from_affine /
# rows_from_points): affine x || y || Z-indicator || pad, projective
# x || y || z || pad.
AFFINE_LANES, PROJ_LANES = 40, 64
# The bucket kernels' split (bucket_split): threads to aim for; the most
# threads per column; the fewest pad slots per chunk.  At the masked
# kernel's 154 registers a thread, T = 4 at the n = 16384 decider's 7,936
# columns (blocks of 128 threads, three an SM) beat T = 8 (blocks of 256,
# one an SM, two waves) by 8 to 15 %, and T = 2 at the prover's 15,872
# columns beat T = 4 by 11 % on the H100 (PERF.md): so 2^14 threads.
BUCKET_FILL_THREADS, BUCKET_MAX_SPLIT, BUCKET_MIN_CHUNK = 1 << 14, 16, 8
# bucket_accum adds every slot of a column, so a split pays while it
# shortens a column's chain of adds (q = pad / T, then log2 T tree levels):
# down to chunks of two slots.  At the n = 16384 rowperm MSM's folded top
# window (48 slots, 1,024 columns) T = 16 took 24 to 29 % less time than
# bucket_split's T = 4 (chunks of 8) on the H100; at the main group (128
# slots, 7,936 columns) the fill target keeps T = 4, the best of the sweep
# (PERF.md).
ACCUM_MIN_CHUNK = 2
# fmul's threads per block (one lane each); chip_smoke.py times 64, 128 and
# 256 at 65,536 lanes: within 1 % of each other, 64 the fastest on average
# (PERF.md).
FMUL_THREADS = 64
_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@dataclass
class Kernel:
    """One CUDA kernel: `csrc/<name>.cu` exports `halo_<name>(*argtypes)`,
    which returns cudaGetLastError().  launches counts the launches since
    reset_launches(), widths the same launches by width (lanes, or columns
    of the bucket kernels).  replaces names the JAX package's code it
    stands for; note says when that is XLA glue, not a Pallas kernel."""

    name: str
    replaces: str
    argtypes: list
    note: str = ""
    launches: int = 0
    widths: Counter = field(default_factory=Counter)
    fn: Callable | None = None
    lib: ctypes.CDLL | None = None

    @property
    def source(self) -> str:
        return f"halo_accumulation_tpu_torch/csrc/{self.name}.cu"


KERNELS = {
    k.name: k
    for k in (
        Kernel("fmul", "halo_accumulation_tpu/ops/pallas_kernels.py:65", [_VP] * 3 + [_I64, _I32, _VP]),
        Kernel("padd", "halo_accumulation_tpu/ops/pallas_kernels.py:69", [_VP] * 9 + [_I64, _VP]),
        Kernel("pdbl", "halo_accumulation_tpu/ops/pallas_kernels.py:346", [_VP] * 6 + [_I64, _I32, _VP]),
        Kernel("bucket_masked", "halo_accumulation_tpu/ops/pallas_kernels.py:262",
               [_VP] * 5 + [_I32, _I64, _I64, _I32, _VP]),
        Kernel("bucket_accum", "halo_accumulation_tpu/ops/pallas_kernels.py:170",
               [_VP] * 5 + [_I32, _I64, _I64, _I32, _VP]),
        Kernel("finv", "halo_accumulation_tpu/ops/field.py:308", [_VP, _VP, _I64, _I32, _VP],
               "port kernel, no Pallas site: Field.pow_const at the root of Field.inv (:320), XLA glue"),
        Kernel("rho_round", "halo_accumulation_tpu/pcdl.py:623",
               [_VP, _I64, _VP, _VP, _I64, _VP, _VP, _VP, _I64, _VP, _VP, _VP],
               "port kernel, no Pallas site: _rho_round_device and _ser_point_words (:607) over "
               "ops/keccak.py, XLA glue"),
    )
}


def load() -> None:
    """Build every kernel that is not built yet and bind its C entry point."""
    paths = runtime.build_kernels(list(KERNELS))
    for name, path in paths.items():
        k = KERNELS[name]
        if k.fn is None:
            k.lib = ctypes.CDLL(str(path))
            fn = getattr(k.lib, f"halo_{name}")
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            k.fn = fn


def ptxas_report() -> dict[str, dict]:
    """Per kernel source, parse_ptxas of its build log."""
    return {name: parse_ptxas(runtime.build_log(name)) for name in KERNELS}


def parse_ptxas(log: str) -> dict[str, dict]:
    """ptxas -v output -> {function: {"registers" (entry functions),
    "stack", "spill_stores", "spill_loads"}}.  ptxas compiles a called
    device function once per entry that calls it, so a callee is keyed
    "<entry>/<callee>", e.g. "pdbl_kernel/halo::mul"."""
    funcs: dict[str, dict] = {}
    entry = cur = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = cur = _symbol(m.group(1))
        elif m := re.search(r"Function properties for (\S+)", line):
            name = _symbol(m.group(1))
            cur = name if entry in (None, name) else f"{entry}/{name}"
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
            funcs.setdefault(cur, {}).update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        elif m := re.search(r"Used (\d+) registers", line):
            funcs.setdefault(entry, {})["registers"] = int(m.group(1))
    return funcs


def _symbol(mangled: str) -> str:
    """A short readable name for an Itanium-mangled symbol: its (nested)
    identifiers, e.g. halo::mul or bucket_masked_kernel."""
    nested = mangled.startswith("_ZN")
    s = mangled[3:] if nested else mangled[2:] if mangled.startswith("_Z") else ""
    parts = []
    while m := re.match(r"\d+", s):
        n = int(m.group())
        parts.append(s[m.end() : m.end() + n])
        s = s[m.end() + n :]
        if not nested:
            break
    return "::".join(p for p in parts if not p.startswith("_GLOBAL__N")) or mangled


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.widths.clear()


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def launch_widths() -> dict[str, dict[int, int]]:
    """{kernel: {width: launches}} since reset_launches(), widths ascending."""
    return {name: dict(sorted(k.widths.items())) for name, k in KERNELS.items()}


# A graph's launches: a Python wrapper counts when it runs, which under a
# CUDA graph is at capture only (runtime.graphed).  The capture's counts are
# taken back (its launches run nothing) and kept with the graph, and every
# replay adds them again, so the counts stay those of the eager path.


def launch_record() -> dict:
    """Every kernel's launches and launches by width, now."""
    return {name: (k.launches, Counter(k.widths)) for name, k in KERNELS.items()}


def launches_since(mark: dict) -> dict:
    """The launches made since launch_record() returned mark."""
    return {name: (k.launches - mark[name][0], k.widths - mark[name][1]) for name, k in KERNELS.items()}


def restore_launches(mark: dict) -> None:
    for name, (n, widths) in mark.items():
        KERNELS[name].launches = n
        KERNELS[name].widths = Counter(widths)


def add_launches(delta: dict) -> None:
    for name, (n, widths) in delta.items():
        KERNELS[name].launches += n
        KERNELS[name].widths.update(widths)


# -- plain twins ----------------------------------------------------------------


def _stk(*xs):
    return torch.stack(xs, dim=1)  # (L, k, *batch)


def fmul_plain(a, b):
    return FQ.mul(a, b)


def padd_plain(P, Q):
    """RCB16 algorithm 7 (a = 0, b3 = 15) on (x, y, z) limb tensors, the
    multiplies grouped into two stacked calls."""
    f = FQ
    x1, y1, z1 = P
    x2, y2, z2 = Q
    s1, s2, s3 = f.add(_stk(x1, y1, x1), _stk(y1, z1, z1)).unbind(1)
    s4, s5, s6 = f.add(_stk(x2, y2, x2), _stk(y2, z2, z2)).unbind(1)
    t0, t1, t2, m3, m4, m5 = f.mul(_stk(x1, y1, z1, s1, s2, s3), _stk(x2, y2, z2, s4, s5, s6)).unbind(1)
    sums = f.add(_stk(t0, t1, t0), _stk(t1, t2, t2))
    t3, t4, w = f.sub(_stk(m3, m4, m5), sums).unbind(1)
    t2b, wb = f.mul_small(_stk(t2, w), B3).unbind(1)
    t0b = f.add(f.add(t0, t0), t0)
    z3s = f.add(t1, t2b)
    t1b = f.sub(t1, t2b)
    x3a, t2c, y3a, t1c, t0c, z3c = f.mul(
        _stk(t4, t3, wb, t1b, t0b, z3s), _stk(wb, t1b, t0b, z3s, t3, t4)
    ).unbind(1)
    r1, r2 = f.add(_stk(t1c, z3c), _stk(y3a, t0c)).unbind(1)
    return f.sub(t2c, x3a), r1, r2


def pdbl_plain(P, k: int = 1):
    """k doublings, each RCB16 algorithm 9 (a = 0) with its multiplies
    grouped into three calls."""
    f = FQ
    x, y, z = P
    for _ in range(k):
        t0, t1, zz = f.mul(_stk(y, y, z), _stk(y, z, z)).unbind(1)
        t2 = f.mul_small(zz, B3)
        z38 = f.mul_small(t0, 8)
        y3s = f.add(t0, t2)
        t0a = f.sub(t0, f.mul_small(t2, 3))
        x3a, z3, xy = f.mul(_stk(t2, t1, x), _stk(z38, z38, y)).unbind(1)
        y3b, x3b = f.mul(_stk(t0a, t0a), _stk(y3s, xy)).unbind(1)
        x, y, z = f.add(x3b, x3b), f.add(x3a, y3b), z3
    return x, y, z


def finv_plain(a, field):
    """a^(p - 2) of (18, n) limbs by the field's square-and-multiply."""
    return field.pow_const(a, field.p - 2)


rho_round_plain = keccak.rho_round


def unpack_affine_planes(packed):
    """(L, ...) pair-packed planes -> (x, y) canonical limb tensors."""
    flat = torch.stack([packed & 0x7FFF, (packed >> W) & 0x7FFF], dim=1).reshape((2 * L,) + tuple(packed.shape[1:]))
    return flat[:L], flat[L:]


def _identity_cols(n: int, device):
    x = torch.zeros((L, n), dtype=I64, device=device)
    y = x.clone()
    y[0] = 1
    return x, y, x.clone()


def bucket_split(padp: int, cols: int, min_chunk: int = BUCKET_MIN_CHUNK) -> int:
    """Threads per column T of a bucket kernel, from the shapes alone
    (never from the device, so that kernel and twin follow the same
    chunks): the smallest power of two with cols * T >= BUCKET_FILL_THREADS,
    but at least 2, at most BUCKET_MAX_SPLIT, and doubled only while a chunk
    of the pad, padp / T slots, still spans at least min_chunk.  Two halves
    pay even on a full card: a warp waits for the longest chunk of its
    columns, and the last wave is fuller (PERF.md)."""
    T = 1
    while (T < BUCKET_MAX_SPLIT and padp >= 2 * T * min_chunk
           and (T == 1 or cols * T < BUCKET_FILL_THREADS)):
        T *= 2
    return T


def accum_split(pad: int, cols: int) -> int:
    """Threads per column T of bucket_accum: bucket_split with chunks down
    to ACCUM_MIN_CHUNK slots."""
    return bucket_split(pad, cols, ACCUM_MIN_CHUNK)


def slot_points(sl, lanes: int):
    """Gathered slots (lanes, n) -> (x, y, z) limb tensors: lanes 18 are
    pair-packed affine x || y with Z = 1, lanes 54 projective x || y || z."""
    if lanes != L:
        return sl[:L], sl[L : 2 * L], sl[2 * L :]
    sx, sy = unpack_affine_planes(sl)
    sz = torch.zeros_like(sx)
    sz[0] = 1
    return sx, sy, sz


def bucket_masked_plain(M, meta, T: int):
    """Per column, the complete-add sum of the live slots off <= p < end =
    min(off + len, padp) of M (lanes, padp, cols), split as the kernel
    splits it.  With q = ceil((end - off) / T), chunk j = [off + j q,
    min(off + (j + 1) q, end)) is summed from the identity in increasing p
    (dead slots are skipped); then the T partials meet in _combine_split's
    tree.  A dead column stays exactly (0 : 1 : 0); T = 1 is one ordered
    sum per column."""
    lanes, padp, cols = M.shape
    dev = M.device
    acc = list(_identity_cols(T * cols, dev))
    if cols == 0:
        return tuple(acc)
    off = meta[0] & 7
    end = torch.clamp(off + (meta[0] >> 3), max=padp)
    q = (torch.clamp(end - off, min=0) + T - 1) // T
    start = off + torch.arange(T, device=dev)[:, None] * q  # (T, cols): chunk j of column c
    clen = torch.clamp(torch.minimum(start + q, end) - start, min=0).reshape(-1)
    first = start.reshape(-1)
    col = torch.arange(T * cols, device=dev) % cols
    for i in range(int(clen.max())):
        v = (clen > i).nonzero().squeeze(1)
        S = slot_points(M[:, first[v] + i, col[v]], lanes)
        for a, s in zip(acc, padd_plain(tuple(a[:, v] for a in acc), S)):
            a[:, v] = s
    return _combine_split(acc, start < end)


def _combine_split(acc, nonempty):
    """The T partial sums of each column, acc (x, y, z) each (18, T * cols)
    chunk-major, combined as csrc/split.cuh combines them: at level s,
    partial j += partial j + 2^s for j a multiple of 2^(s+1), where chunk
    j + 2^s of that column is not empty (nonempty: (T, cols) bool).
    -> each column's sum, (x, y, z) each (18, cols)."""
    T, cols = nonempty.shape
    tree = [a.reshape(L, T, cols) for a in acc]
    h = 1
    while h < T:
        left = torch.arange(0, T, 2 * h, device=nonempty.device)
        jj, cc = nonempty[left + h].nonzero(as_tuple=True)
        jl, jr = left[jj], left[jj] + h
        for a, s in zip(tree, padd_plain(tuple(a[:, jl, cc] for a in tree), tuple(a[:, jr, cc] for a in tree))):
            a[:, jl, cc] = s
        h *= 2
    return tuple(a[:, 0].contiguous() for a in tree)


def decode_rows(t):
    """(lanes, n) transposed table rows -> (x, y, z) limb tensors (18, n):
    lanes 40 carry only Z's low limb (1 for a point, 0 for the sentinel)."""
    x, y = t[:L], t[L : 2 * L]
    if t.shape[0] == AFFINE_LANES:
        z = torch.zeros_like(x)
        z[0] = t[2 * L]
        return x, y, z
    return x, y, t[2 * L : 3 * L]


def bucket_accum_plain(rows, src, T: int = 1):
    """Per column, the complete-add sum of rows[src[p, col]] over every slot
    p = 0 .. pad - 1 (sentinel slots included), split as the kernel splits
    it: with q = ceil(pad / T), chunk j = [j q, min((j + 1) q, pad)) is
    summed from the identity in increasing p, then the T partials meet in
    _combine_split's tree.  T = 1 is one ordered sum per column, the Pallas
    kernels' order.  rows (nrows, 40 or 64), src (pad, cols) -> (x, y, z)
    each (18, cols)."""
    pad, cols = src.shape
    table = rows.T.contiguous()
    q = -(-pad // T)
    acc = _identity_cols(T * cols, rows.device)
    for i in range(q):
        js = [j for j in range(T) if j * q + i < pad]  # chunks that still hold a slot
        S = decode_rows(table[:, src[[j * q + i for j in js]].reshape(-1)])
        if len(js) == T:
            acc = padd_plain(acc, S)
        else:
            v = slice(0, len(js) * cols)  # chunks are contiguous: the live ones come first
            for a, s in zip(acc, padd_plain(tuple(a[:, v] for a in acc), S)):
                a[:, v] = s
    nonempty = torch.arange(T, device=rows.device)[:, None] * q < pad
    return _combine_split(acc, nonempty.expand(T, cols))


# -- wrappers -------------------------------------------------------------------


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_planes(*ts, rows: int = L):
    n = ts[0].shape[1] if ts[0].dim() == 2 else -1
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if t.dtype != I64:
            raise TypeError(f"kernel input dtype {t.dtype}, expected int64 limbs")
        if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != n:
            raise ValueError(f"kernel input shape {tuple(t.shape)}, expected ({rows}, {n})")
    return n


def _launch(name: str, width: int, *args) -> None:
    k = KERNELS[name]
    if k.fn is None:
        load()
    rc = k.fn(*args, _stream())
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    k.launches += 1
    k.widths[width] += 1


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on {sorted(devs)}: expected all CPU or all CUDA")


def fmul(a, b, threads: int = FMUL_THREADS):
    """Fq multiply of (18, n) limb tensors; on the card in blocks of
    `threads` (a multiple of 32, at most 1024)."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"fmul threads {threads}: expected a multiple of 32 from 32 to 1024")
    if _on_cpu(a, b):
        return fmul_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    n = _check_planes(a, b)
    out = torch.empty_like(a)
    if n:
        _launch("fmul", n, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, threads)
    return out


def padd(P, Q):
    """Complete add of two (x, y, z) tuples of (18, n) limb tensors."""
    if _on_cpu(*P, *Q):
        return padd_plain(P, Q)
    ins = [t.contiguous() for t in (*P, *Q)]
    n = _check_planes(*ins)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("padd", n, *(t.data_ptr() for t in ins + outs), n)
    return tuple(outs)


def pdbl(P, k: int = 1):
    """k complete doubles of an (x, y, z) tuple of (18, n) limb tensors, in
    one launch."""
    if k < 1:
        raise ValueError(f"pdbl takes k >= 1 doublings, got {k}")
    if _on_cpu(*P):
        return pdbl_plain(P, k)
    ins = [t.contiguous() for t in P]
    n = _check_planes(*ins)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _launch("pdbl", n, *(t.data_ptr() for t in ins + outs), n, k)
    return tuple(outs)


def bucket_masked(M, meta, T: int | None = None):
    """Masked bucket reduction: M (18 or 54, padp, cols) int64, meta
    (1, cols) int64 off | len << 3 -> (x, y, z) each (18, cols).  T: threads
    per column (default bucket_split(padp, cols)), for the kernel and the
    twin alike."""
    lanes, padp, cols = M.shape
    T = bucket_split(padp, cols) if T is None else T
    if T not in (1, 2, 4, 8, 16):
        raise ValueError(f"bucket_masked splits a column 1, 2, 4, 8 or 16 ways, got {T}")
    if _on_cpu(M, meta):
        return bucket_masked_plain(M, meta, T)
    if lanes not in (L, 3 * L):
        raise ValueError(f"bucket_masked takes 18 or 54 lanes, got {lanes}")
    if M.dtype != I64 or meta.dtype != I64:
        raise TypeError("bucket_masked takes int64 planes and meta")
    if tuple(meta.shape) != (1, cols):
        raise ValueError(f"meta shape {tuple(meta.shape)}, expected (1, {cols})")
    M, meta = M.contiguous(), meta.contiguous()
    outs = [torch.empty((L, cols), dtype=I64, device=M.device) for _ in range(3)]
    if cols:
        _launch("bucket_masked", cols, M.data_ptr(), meta.data_ptr(), *(o.data_ptr() for o in outs),
                lanes, padp, cols, T)
    return tuple(outs)


def bucket_accum(rows, src, T: int | None = None):
    """Row-permutation bucket sums: rows (nrows, 40 or 64) int64 table,
    src (pad, cols) int64 row indices in [0, nrows) -> (x, y, z) each
    (18, cols).  T: threads per column (default accum_split(pad, cols)),
    for the kernel and the twin alike.  The kernel gathers its rows itself;
    the indices are trusted (the MSM builds them)."""
    if src.dim() != 2:
        raise ValueError(f"bucket_accum takes (pad, cols) indices, got {tuple(src.shape)}")
    pad, cols = src.shape
    T = accum_split(pad, cols) if T is None else T
    if T not in (1, 2, 4, 8, 16):
        raise ValueError(f"bucket_accum splits a column 1, 2, 4, 8 or 16 ways, got {T}")
    if _on_cpu(rows, src):
        return bucket_accum_plain(rows, src, T)
    if rows.dim() != 2 or rows.shape[1] not in (AFFINE_LANES, PROJ_LANES):
        raise ValueError(f"bucket_accum takes (nrows, 40 or 64) rows, got {tuple(rows.shape)}")
    if rows.dtype != I64 or src.dtype != I64:
        raise TypeError("bucket_accum takes int64 rows and indices")
    rows, src = rows.contiguous(), src.contiguous()
    outs = [torch.empty((L, cols), dtype=I64, device=rows.device) for _ in range(3)]
    if cols:
        _launch("bucket_accum", cols, rows.data_ptr(), src.data_ptr(), *(o.data_ptr() for o in outs),
                rows.shape[1], pad, cols, T)
    return tuple(outs)


def finv(a, field):
    """Lane-wise inverse a^-1 (0 for 0) of (18, n) limbs of `field`,
    ops.field's FQ or FR."""
    if field is not FQ and field is not FR:
        raise ValueError(f"finv takes FQ or FR, got {field!r}")
    if _on_cpu(a):
        return finv_plain(a, field)
    a = a.contiguous()
    n = _check_planes(a)
    out = torch.empty_like(a)
    if n:
        _launch("finv", n, a.data_ptr(), out.data_ptr(), n, int(field is FR))
    return out


def rho_round(xi, Lax, Lay, Linf, Rax, Ray, Rinf):
    """One round's challenge rho_0(ser(xi), ser_point(L), ser_point(R)) as
    canonical (18,) Fr limbs, from canonical (18,) limb vectors (any
    stride; L's two coordinates share one, as do R's) and 0-dim bool
    infinity flags; the card's result stays on the card."""
    ts = (xi, Lax, Lay, Linf, Rax, Ray, Rinf)
    if _on_cpu(*ts):
        return rho_round_plain(*ts)
    for t in (xi, Lax, Lay, Rax, Ray):
        if t.dtype != I64 or tuple(t.shape) != (L,):
            raise ValueError(f"rho_round takes (18,) int64 limb vectors, got {t.dtype} {tuple(t.shape)}")
    for f in (Linf, Rinf):
        if f.dtype != torch.bool or f.numel() != 1:
            raise ValueError("rho_round takes one bool infinity flag per point")
    if Lax.stride(0) != Lay.stride(0):
        Lax, Lay = Lax.contiguous(), Lay.contiguous()
    if Rax.stride(0) != Ray.stride(0):
        Rax, Ray = Rax.contiguous(), Ray.contiguous()
    out = torch.empty(L, dtype=I64, device=xi.device)
    _launch("rho_round", 1, xi.data_ptr(), xi.stride(0), Lax.data_ptr(), Lay.data_ptr(), Lax.stride(0),
            Linf.data_ptr(), Rax.data_ptr(), Ray.data_ptr(), Rax.stride(0), Rinf.data_ptr(), out.data_ptr())
    return out
