"""Public parameters (URS): hash-derived generators S, H, G_0..G_{n-1}.

The reference's untrusted setup, as in `halo_accumulation_tpu/pp.py`:

    gen(i) = Fr::from_le_bytes_mod_order(
                 SHA3-256(b"To understand recursion, ..." || i as u64 LE)) * G
    S = gen(0), H = gen(1), G_i = gen(i + 2)

The scalars are hashed on the host; the fixed-base multiplications run on
the device as 8-bit windowed table lookups (32 tables of 256 multiples of
2^(8w) G, built on the host) summed by complete adds, then one batched
normalization.  The n-generator URS is a prefix of any larger one, so
`get_pp` serves smaller sizes by slicing the smallest larger one it holds,
in memory or on disk.

The disk cache is the JAX package's: `urs_<n>.npz` in the directory
HALO_TPU_URS_CACHE (default `.urs_cache/` at the repository root), holding
gs_x and gs_y as (18, n) uint32 canonical limbs and s_x, s_y, h_x, h_y as
decimal strings; a file either package writes loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np
import torch

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import runtime
from halo_accumulation_tpu_torch.ops import curve as cv
from halo_accumulation_tpu_torch.ops import msm as msm_mod
from halo_accumulation_tpu_torch.ops.field import FQ, L

GENESIS = b"To understand recursion, one must first understand recursion"

_WINDOW = 8
_NWIN = 32  # 256 bits / 8


def gen_scalar(i: int) -> int:
    h = hashlib.sha3_256()
    h.update(GENESIS)
    h.update(i.to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little") % F.R


def _window_tables(device) -> cv.PointVec:
    """(18, 32, 256) projective table: T[w][j] = j * 2^(8w) * G."""
    pts = []
    base = (F.G_X, F.G_Y)
    for _ in range(_NWIN):
        acc = None
        row = [None]
        for _ in range(1, 256):
            acc = F.p_add(acc, base)
            row.append(acc)
        pts.extend(row)
        for _ in range(_WINDOW):
            base = F.p_add(base, base)
    P = cv.from_affine_ints(pts, device)
    return cv.PointVec(*(a.reshape(L, _NWIN, 256) for a in P))


def _fixed_base_mul_batch(tables: cv.PointVec, digits) -> cv.PointVec:
    """digits (32, N) byte values -> sum_w T[w][digit_w] per column."""
    idx = digits[None].expand((L,) + tuple(digits.shape))
    g = cv.PointVec(*(torch.gather(t, 2, idx) for t in tables))  # (18, 32, N)
    return cv.sum_points(g, axis=0)


class PublicParams:
    """Device-resident URS: gs_x / gs_y are canonical (18, n) int64 limbs of
    the affine G vector; s and h are host affine int pairs."""

    def __init__(self, n: int, gs_x, gs_y, s, h):
        self.n = n
        self.d = n - 1
        self.gs_x = gs_x
        self.gs_y = gs_y
        self.s = s
        self.h = h
        self._gs_host: list = []
        self._gs_planes: dict[int, torch.Tensor] = {}
        self._gs_rows: dict[tuple[int, bool], torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.gs_x.device

    def gs_points(self, n: int) -> cv.PointVec:
        """First n generators as a projective PointVec (Z = 1)."""
        one = FQ.from_int(1, (n,), self.device).contiguous()
        return cv.PointVec(self.gs_x[:, :n], self.gs_y[:, :n], one)

    def gs_planes(self, n: int):
        """First n generators as cached pair-packed affine planes (18, n),
        the sort payload of the fixed-base MSMs."""
        r = self._gs_planes.get(n)
        if r is None:
            r = msm_mod.planes_from_affine(self.gs_x[:, :n], self.gs_y[:, :n])
            self._gs_planes[n] = r
        return r

    def gs_rows(self, n: int, projective: bool = False):
        """First n generators as a cached row table, the gather source of the
        row-permutation fixed-base MSMs: (n + 1, 40) affine rows, or
        (n + 1, 64) projective ones (Z = 1), the form of the prover's rounds."""
        r = self._gs_rows.get((n, projective))
        if r is None:
            if projective:
                r = msm_mod.rows_from_points(self.gs_points(n))
            else:
                r = msm_mod.rows_from_affine(self.gs_x[:, :n], self.gs_y[:, :n])
            self._gs_rows[(n, projective)] = r
        return r

    def gs_host(self, k: int = 8) -> list:
        """First k generators as host affine int pairs (cached prefix)."""
        if len(self._gs_host) < k:
            xs = FQ.to_ints(self.gs_x[:, :k])
            ys = FQ.to_ints(self.gs_y[:, :k])
            self._gs_host = list(zip(xs, ys))
        return self._gs_host[:k]


def _check_size(n: int) -> None:
    if n & (n - 1):
        raise AssertionError("URS size must be a power of two")


def generate(n: int, device=None) -> PublicParams:
    """Compute the n-generator URS on `device` (the card by default)."""
    _check_size(n)
    dev = runtime.device(device)
    tables = _window_tables(dev)
    # the 8-bit windows of a little-endian scalar are its bytes
    blob = b"".join(gen_scalar(i).to_bytes(32, "little") for i in range(n + 2))
    dig = np.frombuffer(blob, np.uint8).reshape(n + 2, 32).T.astype(np.int64)
    P = _fixed_base_mul_batch(tables, torch.from_numpy(dig).to(dev))
    x, y, inf = cv.to_affine(P)
    if bool(inf.any()):
        raise AssertionError("URS generator hashed to identity")
    s_pt, h_pt = [(a, b) for a, b in zip(FQ.to_ints(x[:, :2]), FQ.to_ints(y[:, :2]))]
    return PublicParams(n, x[:, 2:].contiguous(), y[:, 2:].contiguous(), s_pt, h_pt)


_pp_cache: dict = {}
_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def cache_dir() -> pathlib.Path:
    """The URS disk cache's directory: HALO_TPU_URS_CACHE, read at each call."""
    return pathlib.Path(os.environ.get("HALO_TPU_URS_CACHE", str(_REPO_ROOT / ".urs_cache")))


def _cached_file(n: int):
    """urs_<n>.npz, else the urs_<m>.npz with the smallest m > n, in the
    cache directory; None when there is neither.  Names whose <m> is not
    an integer are not cache files."""
    d = cache_dir()
    exact = d / f"urs_{n}.npz"
    if exact.exists():
        return exact
    sizes = []
    for q in d.glob("urs_*.npz"):
        try:
            m = int(q.stem.split("_")[1])
        except ValueError:
            continue
        if m > n:
            sizes.append((m, q))
    return min(sizes)[1] if sizes else None


def _load(path: pathlib.Path, n: int, device) -> PublicParams:
    """The first n generators of a cache file; ValueError naming the file
    when it does not parse or holds fewer than n."""
    try:
        with np.load(path) as z:
            gx, gy = z["gs_x"], z["gs_y"]
            s, h = (int(z["s_x"]), int(z["s_y"])), (int(z["h_x"]), int(z["h_y"]))
    except Exception as e:
        raise ValueError(f"URS cache file {path} does not parse: {e!r}") from e
    if gx.ndim != 2 or gx.shape[0] != L or gx.shape[1] < n or gy.shape != gx.shape:
        raise ValueError(f"URS cache file {path} holds gs_x {gx.shape}, gs_y {gy.shape}; needs (18, >= {n})")
    return from_numpy(gx[:, :n], gy[:, :n], s, h, device)


def _save(pp: PublicParams, path: pathlib.Path) -> None:
    """Write pp in the JAX package's layout, through a temporary file and a
    rename, so a reader never sees half a file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    gx, gy, s, h = to_numpy(pp)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, gs_x=gx, gs_y=gy, s_x=str(s[0]), s_y=str(s[1]), h_x=str(h[0]), h_y=str(h[1]))
    os.replace(tmp, path)


def get_pp(n: int, device=None, use_disk_cache: bool = True) -> PublicParams:
    """The n-generator URS on `device` (the card by default; "cpu" only when
    named): from memory, sliced from the smallest larger URS held, else
    from the disk cache (the JAX package's rule: urs_<n>.npz or the
    smallest larger file, sliced), else generated, and then written to the
    cache as urs_<n>.npz.  A cache file that exists but does not parse
    raises."""
    _check_size(n)
    dev = runtime.device(device)
    key = (n, str(dev))
    if key in _pp_cache:
        return _pp_cache[key]
    bigger = [m for (m, d) in _pp_cache if d == str(dev) and m > n]
    path = _cached_file(n) if use_disk_cache and not bigger else None
    if bigger:
        big = _pp_cache[(min(bigger), str(dev))]
        pp = PublicParams(n, big.gs_x[:, :n], big.gs_y[:, :n], big.s, big.h)
    elif path is not None:
        pp = _load(path, n, dev)
    else:
        pp = generate(n, dev)
        if use_disk_cache:
            _save(pp, cache_dir() / f"urs_{n}.npz")
    _pp_cache[key] = pp
    return pp


def from_numpy(gs_x, gs_y, s, h, device=None) -> PublicParams:
    """PublicParams from (18, n) limb arrays (any integer dtype, e.g. the JAX
    package's uint32 URS) and host (x, y) pairs for S and H."""
    dev = runtime.device(device)
    gx = torch.from_numpy(np.asarray(gs_x).astype(np.int64)).to(dev)
    gy = torch.from_numpy(np.asarray(gs_y).astype(np.int64)).to(dev)
    return PublicParams(gx.shape[1], gx, gy, tuple(s), tuple(h))


def to_numpy(pp: PublicParams):
    """(gs_x, gs_y, s, h): (18, n) uint32 canonical limbs and host pairs."""
    gx = pp.gs_x.cpu().numpy().astype(np.uint32)
    gy = pp.gs_y.cpu().numpy().astype(np.uint32)
    return gx, gy, pp.s, pp.h
