"""Multi-scalar multiplication (Pippenger) in PyTorch.

Counterpart of `halo_accumulation_tpu/ops/msm.py`.  Two bucket pipelines,
chosen by HALO_TPU_MSM_IMPL as in the JAX package (`_impl`):

  * "sortrows" (the default) - `_sortrows_msm` / `msm_flagged` /
    `msm_many_flagged`: the sort-payload Pippenger.  Per window the point
    coordinate planes are sorted along with the digit key, bucket
    boundaries come from searchsorted, buckets expand with 8-row-aligned
    block gathers, and the masked bucket kernel (ops/cuda_kernels.
    bucket_masked) sums each bucket, masking the ragged block edges by a
    per-column (off, len) word.  With route bits (nroute = 2) two scalar
    vectors of disjoint support share one sort: the IPA prover's L and R.
  * "rowperm" - `_rowperm_msm`: points live as rows of a table whose last
    row is the identity sentinel; a packed-key sort gives each
    (window, bucket, slot) cell its point's row index (`_perm_slots`), and
    the bucket kernel (ops/cuda_kernels.bucket_accum) gathers and sums each
    column's rows.  Narrow window groups fold their pad axis K ways across
    columns first (`_bucket_group_rows`).
  * "staged" (any value other than those two, as in the JAX package) -
    `_staged_msm` / `_msm_measured`: each window's points are scattered
    into a (window, bucket x pad) identity matrix by their sort ranks and
    summed over the pad axis with the complete add (`_bucket_sums_chunk`);
    the backstop after a pinned-pad overflow under every setting (pads
    measured from the digits, points chunked until one window's matrix
    fits `_SCATTER_BUDGET_COLS`), and the stage the sharded MSM runs on
    each rank (parallel/msm_sharded.py).
  * All finish with suffix-doubling bucket weighting and a Horner window
    combine.  Zero digits go to bucket 0, which has weight 0: zero-padded
    scalar vectors cost almost nothing on the sort-payload path.
  * Pads (the most points a bucket may hold) are PINNED per size class with
    a device validity flag; on the rare overflow `msm` falls back to the
    staged pipeline with pads measured from the digits (`_msm_measured`).
  * `msm_rows`: many small independent MSMs, one per row, by a 4-bit
    windowed double-and-add (the batched succinct checks).
  * `fold_basis`: the device-transcript open's collapse of a basis by 16,
    sixteen scalars shared by every column (Strauss).
  * `fixed_base*`: the MSMs over the URS (commitments, the prover's rounds,
    the deciders' deferred MSM).  They pick the pipeline and the URS table
    it reads (`_sortrows` is the one reader of the setting), so pcdl.py
    never branches on it.

There is no jit here, so shapes need no padding to size classes: every call
runs eagerly at its exact width.
"""

from __future__ import annotations

import math
import os

import torch

from halo_accumulation_tpu_torch import fields as _fields
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
from halo_accumulation_tpu_torch.ops import curve as cv
from halo_accumulation_tpu_torch.ops.field import FQ, FR, I64, L

NBITS = 255
# Most point columns (window group x buckets x pad) one sorted group may
# gather at once; larger window runs are split into several groups.
_SORT_BUDGET_COLS = 1 << 24
# The same for one row-permutation group's index matrix and for one staged
# window group's scatter matrix (the JAX package's scatter budget).
_SCATTER_BUDGET_COLS = 1 << 21
_SORTROWS_MIN = 128  # narrower MSMs take the row-permutation pipeline
_LADDER_MAX = 256  # unpadded MSMs this narrow take the exact ladder
# Column width the K-way pad fold fills (the JAX package's g = 1024).
_FOLD_COLS = 1024


def _impl() -> str:
    """HALO_TPU_MSM_IMPL, as the JAX package reads it: "sortrows" (the
    default), "rowperm", or "staged"; every other value runs the staged
    pipeline too (`_staged`)."""
    return os.environ.get("HALO_TPU_MSM_IMPL", "sortrows")


def _staged() -> bool:
    """Whether the setting selects the staged pipeline: any value other
    than "sortrows" and "rowperm"."""
    return _impl() not in ("sortrows", "rowperm")


def window_size(n: int) -> int:
    if n >= (1 << 18):
        return 12
    if n >= (1 << 15):
        return 10
    if n >= (1 << 11):
        return 8
    if n >= (1 << 8):
        return 6
    return 4


def num_windows(c: int) -> int:
    return (NBITS + c - 1) // c


def _round_pad(m: int) -> int:
    """Next size class: {2^k, 3 * 2^(k-1)} up to 2048, multiples of 1024 above."""
    if m <= 2:
        return max(1, m)
    if m > 2048:
        return ((m + 1023) // 1024) * 1024
    p = 1
    while True:
        if p >= m:
            return p
        if 3 * p // 2 >= m and p >= 2:
            return 3 * p // 2
        p *= 2


def _beffs(c: int) -> list[int]:
    """Bucket-space size per window, msb window first.  Canonical scalars
    are < r, which cuts the top window's digit range."""
    W = num_windows(c)
    top_bound = ((_fields.R - 1) >> ((W - 1) * c)) + 1
    top = 1
    while top < top_bound:
        top *= 2
    return [min(top, 1 << c)] + [1 << c] * (W - 1)


def pinned_pads(n: int, c: int) -> list[int]:
    """Per-window pads for n roughly uniform scalars: the mean bucket count
    plus ~6 sigma, the top window's mean taken over its real digit range."""
    W = num_windows(c)
    top_bound = ((_fields.R - 1) >> ((W - 1) * c)) + 1

    def pad_for(nbuckets: int) -> int:
        mean = max(1, (max(n, 1) + nbuckets - 1) // nbuckets)
        return _round_pad(mean + 6 * int(math.sqrt(mean)) + 8)

    return [pad_for(max(1, top_bound - 1))] + [pad_for((1 << c) - 1)] * (W - 1)


def _digits(scalars, c: int):
    """Fr scalars (18, *B) -> (W, *B) int64 window digits, msb window first."""
    s = FR.canon(scalars)
    out = []
    for w in range(num_windows(c)):
        i0, o0 = divmod(w * c, 15)
        d = s[i0] >> o0
        if o0 + c > 15 and i0 + 1 < L:
            d = d | (s[i0 + 1] << (15 - o0))
        if o0 + c > 30 and i0 + 2 < L:
            d = d | (s[i0 + 2] << (30 - o0))
        out.append(d & ((1 << c) - 1))
    out.reverse()
    return torch.stack(out)


def _group_windows(pads: list[int], beffs: list[int]):
    """Runs of consecutive windows sharing (beff, pad) -> [(w0, w1, beff, pad)]."""
    groups = []
    w0 = 0
    for w in range(1, len(pads) + 1):
        if w == len(pads) or (pads[w], beffs[w]) != (pads[w0], beffs[w0]):
            groups.append((w0, w, beffs[w0], pads[w0]))
            w0 = w
    return groups


def _expand_groups_sorted(pads: list[int], beffs: list[int], nroute: int = 1):
    """(pad, beff) runs split so each group's gathered matrix fits the budget."""
    out = []
    for w0, w1, beff, pad in _group_windows(pads, beffs):
        wc = max(1, _SORT_BUDGET_COLS // (beff * nroute * pad))
        for ws in range(w0, w1, wc):
            out.append((ws, min(ws + wc, w1), beff, pad))
    return out


def planes_from_points(points: cv.PointVec):
    """PointVec (18, N) -> (54, N) projective coordinate planes."""
    return torch.cat([points.x, points.y, points.z])


def planes_from_affine(xs, ys):
    """Canonical affine limbs (18, N) each -> (18, N) pair-packed planes:
    plane k holds limbs 2k | 2k+1 << 15 of x || y."""
    flat = torch.cat([xs, ys])
    return flat[0::2] | (flat[1::2] << 15)


unpack_affine_planes = ck.unpack_affine_planes


def _masked_reduce(M, meta) -> cv.PointVec:
    """Per-column sums of the live slots of sorted point data (the masked
    bucket kernel on the card, its plain twin on the CPU)."""
    return cv.PointVec(*ck.bucket_masked(M, meta))


def _shift_adds(T: cv.PointVec, steps: int) -> cv.PointVec:
    """`steps` rounds of T <- T + (T shifted left by 2^i along the last
    axis, identity-filled): after lg(n) rounds position b holds the suffix
    sum of positions >= b.  The shared step of the bucket weighting and the
    strided sum."""
    ident = cv.identity(T.batch_shape, T.x.device)
    for i in range(steps):
        sh = 1 << i
        shifted = cv.PointVec(*(torch.cat([a[:, :, sh:], ia[:, :, :sh]], dim=2) for a, ia in zip(T, ident)))
        T = cv.padd(T, shifted)
    return T


def _first(T: cv.PointVec) -> cv.PointVec:
    return cv.PointVec(T.x[:, :, 0], T.y[:, :, 0], T.z[:, :, 0])


def _suffix_weight(S: cv.PointVec, beff: int) -> cv.PointVec:
    """sum_{b >= 1} b * S_b per window: (18, Wg, beff) -> (18, Wg), by two
    suffix-doubling passes (the second after masking bucket 0)."""
    Wg = S.x.shape[1]
    dev = S.x.device
    if beff == 1:
        return cv.identity((Wg,), dev)
    lgB = beff.bit_length() - 1
    T = _shift_adds(S, lgB)
    T = cv.pselect(torch.arange(beff, device=dev) >= 1, T, cv.identity((Wg, beff), dev))
    return _first(_shift_adds(T, lgB))


def _strided_sum(T: cv.PointVec, K: int) -> cv.PointVec:
    """Sum the last axis (size K, a power of two): (18, C, K) -> (18, C)."""
    return _first(_shift_adds(T, K.bit_length() - 1))


def _sorted_payload(planes, digits_g, pad: int, beff: int, nroute: int = 1):
    """One window group's bucket slots from a payload sort: (M (P, padp,
    Wg * nroute * beff), meta (1, cols) off | len << 3, ok flag), the masked
    bucket kernel's input.  digits_g: (Wg, N) in [0, nroute * beff); N a
    multiple of 8."""
    Wg, N = digits_g.shape
    P = planes.shape[0]
    dev = planes.device
    btot = nroute * beff
    skey, order = torch.sort(digits_g, dim=1)
    splanes = planes[:, order]  # (P, Wg, N) in digit order
    bvals = torch.arange(btot, dtype=I64, device=dev).expand(Wg, btot).contiguous()
    first = torch.searchsorted(skey, bvals, side="left")
    count = torch.searchsorted(skey, bvals, side="right") - first
    # digit 0 of each route is the zero-scalar dump bucket: never gathered
    dump = (torch.arange(btot, device=dev) % beff) == 0
    count = count.masked_fill(dump[None], 0)
    ok = count.max() <= pad
    count = count.clamp(max=pad)
    a = first & ~7  # block-aligned bucket start
    off = first - a
    pad8 = (pad + 7) // 8 + 1  # blocks cover off + count <= 7 + pad
    nblk = Wg * (N // 8)
    blk = a[None] // 8 + torch.arange(pad8, device=dev)[:, None, None]
    gidx = blk + (torch.arange(Wg, device=dev) * (N // 8))[None, :, None]
    # blocks past the last window's end are dead slots: clamp, do not read out of bounds
    gidx = gidx.reshape(-1).clamp(0, nblk - 1)
    blocks = splanes.reshape(P, nblk, 8)[:, gidx]  # (P, pad8 * Wg * btot, 8)
    M = blocks.reshape(P, pad8, Wg, btot, 8).permute(0, 1, 4, 2, 3).reshape(P, pad8 * 8, Wg * btot)
    meta = (off | (count << 3)).reshape(1, Wg * btot)
    return M, meta, ok


def _sorted_group(planes, digits_g, pad: int, beff: int, nroute: int = 1):
    """One window group's weighted sums from a payload sort:
    (PointVec (18, Wg, nroute), ok flag).  digits_g: (Wg, N) in
    [0, nroute * beff); N a multiple of 8."""
    Wg = digits_g.shape[0]
    M, meta, ok = _sorted_payload(planes, digits_g, pad, beff, nroute)
    S = _masked_reduce(M, meta)
    S = cv.PointVec(*(x.reshape(L, Wg * nroute, beff) for x in S))
    V = _suffix_weight(S, beff)
    return cv.PointVec(*(x.reshape(L, Wg, nroute) for x in V)), ok


def _horner_routes(V: cv.PointVec, c: int) -> cv.PointVec:
    """Horner window combine over (18, W, R) per-window points, msb first:
    acc <- 2^c acc + V_w, batched over R.  Returns (18, R)."""
    W, R = V.x.shape[1], V.x.shape[2]
    acc = cv.identity((R,), V.x.device)
    for w in range(W):
        acc = cv.pdbl(acc, c)
        acc = cv.padd(acc, cv.PointVec(V.x[:, w], V.y[:, w], V.z[:, w]))
    return acc


def _cat_groups(Vs):
    return cv.PointVec(*(torch.cat([v[i] for v in Vs], dim=1) for i in range(3)))


def _route_digits(dg, route, beff: int):
    """Shift each point's digits into its route's half of the bucket space."""
    return dg + route[None] * beff


def _sortrows_msm(planes, scalars, c: int, pads: list[int], beffs: list[int], route=None,
                  nroute: int = 1):
    """Sort-payload MSM: ([point] * nroute, ok flag), no host sync.  planes:
    (18, N) pair-packed affine or (54, N) projective; N a multiple of 8.
    route: optional (N,) int64 in [0, nroute) naming each point's output
    (the supports must be disjoint: a point feeds one output)."""
    digits = _digits(scalars, c)
    Vs, oks = [], []
    for w0, w1, beff, pad in _expand_groups_sorted(pads, beffs, nroute):
        dg = digits[w0:w1]
        if route is not None:
            dg = _route_digits(dg, route, beff)
        V, okv = _sorted_group(planes, dg, pad, beff, nroute)
        Vs.append(V)
        oks.append(okv)
    acc = _horner_routes(_cat_groups(Vs), c)
    outs = [cv.PointVec(acc.x[:, r], acc.y[:, r], acc.z[:, r]) for r in range(nroute)]
    return outs, torch.stack(oks).all()


_FOLD_CHUNK = 4096  # fold_basis columns per chunk: bounds its 16-multiple table


def fold_basis(planes, t16):
    """Collapse a pair-packed affine basis (18, W) by 16: with w2 = W / 16,

        B'[j] = sum_{h=0}^{15} t16[:, h] * B[h w2 + j],   j < w2,

    the IPA open's generator fold for four rounds at once (t16: the tensor
    coefficients of the segment's four challenges, shared by every j).
    Shared-scalar Strauss, as the JAX package's fold_basis: per column a
    table of the 16 multiples 0..15 of each of its 16 points (14 adds), then
    the scalars' 64 four-bit windows, msb first: four doublings (one pdbl
    launch of k = 4), the table entries the window's digits pick, summed
    16 ways, and one add.  Chunks of at most _FOLD_CHUNK columns.
    -> (planes' (18, w2) pair-packed affine, any_inf): any_inf, left on the
    device, is True iff a folded point is the identity (negligible; the
    caller then rebuilds the proof on the host path)."""
    Wd = planes.shape[1]
    w2 = Wd // 16
    dev = planes.device
    xs, ys = unpack_affine_planes(planes)
    xs, ys = xs.reshape(L, 16, w2), ys.reshape(L, 16, w2)
    digits = _digits(t16, 4)  # (64, 16), msb window first
    outs = []
    for j0 in range(0, w2, _FOLD_CHUNK):
        ch = min(_FOLD_CHUNK, w2 - j0)
        P = cv.PointVec(xs[:, :, j0 : j0 + ch], ys[:, :, j0 : j0 + ch], FQ.from_int(1, (16, ch), dev))
        tab = [cv.identity((16, ch), dev), P]
        for _ in range(14):
            tab.append(cv.padd(tab[-1], P))
        T = [torch.stack([t[i] for t in tab]) for i in range(3)]  # (16 multiples, 18, 16, ch)
        acc = cv.identity((ch,), dev)
        for k in range(64):
            acc = cv.pdbl(acc, 4)
            idx = digits[k][None, None, :, None].expand(1, L, 16, ch)
            sel = cv.PointVec(*(torch.gather(t, 0, idx)[0] for t in T))  # (18, 16, ch)
            acc = cv.padd(acc, cv.sum_points(sel, axis=0))
        outs.append(acc)
    ax, ay, inf = cv.to_affine(_cat_groups(outs))
    return planes_from_affine(ax, ay), inf.any()


def msm_many_flagged(planes, scalars_many, c: int, pads: list[int], beffs: list[int]):
    """K independent MSMs over one basis: scalars_many (18, K, N) ->
    (PointVec (18, K), ok flag).  The digit rows stack window-major
    (row w * K + k), so each window class of all K MSMs is one sorted group,
    and one Horner combine runs batched over K."""
    K = scalars_many.shape[1]
    digits = _digits(scalars_many, c)  # (W, K, N)
    W = digits.shape[0]
    digits = digits.reshape(W * K, digits.shape[2])
    rep = lambda xs: [x for x in xs for _ in range(K)]  # noqa: E731
    Vs, oks = [], []
    for w0, w1, beff, pad in _expand_groups_sorted(rep(pads), rep(beffs)):
        V, okv = _sorted_group(planes, digits[w0:w1], pad, beff)
        Vs.append(V)
        oks.append(okv)
    V = cv.PointVec(*(x.reshape(L, W, K) for x in _cat_groups(Vs)))
    return _horner_routes(V, c), torch.stack(oks).all()


def _pad_points(points: cv.PointVec, scalars, m: int):
    """Pad to a multiple of m with identity points and zero scalars."""
    N = points.x.shape[1]
    Np = ((N + m - 1) // m) * m
    if Np == N:
        return points, scalars
    ident = cv.identity((Np - N,), points.x.device)
    points = cv.PointVec(*(torch.cat([a, b], dim=1) for a, b in zip(points, ident)))
    scalars = torch.cat([scalars, FR.zeros((Np - N,), scalars.device)], dim=1)
    return points, scalars


# -- row-permutation pipeline ------------------------------------------------------


def rows_from_points(points: cv.PointVec):
    """PointVec (18, N) -> (N + 1, 64) rows x || y || z || zero pad; row N
    is the identity (0 : 1 : 0)."""
    N = points.x.shape[1]
    dev = points.x.device
    rows = torch.zeros((N + 1, ck.PROJ_LANES), dtype=I64, device=dev)
    rows[:N, : 3 * L] = torch.cat(list(points)).T
    rows[N, L] = 1
    return rows


def rows_from_affine(xs, ys):
    """Affine limbs (18, N) each -> (N + 1, 40) rows x || y || Z-indicator
    || zero pad.  Lane 36 carries Z's low limb: 1 for a point, 0 for the
    sentinel row N, whose y0 = 1 makes it the identity (0 : 1 : 0); an
    all-zero row would be (0 : 0 : 0), which absorbs every sum it enters."""
    N = xs.shape[1]
    rows = torch.zeros((N + 1, ck.AFFINE_LANES), dtype=I64, device=xs.device)
    rows[:N, :L] = xs.T
    rows[:N, L : 2 * L] = ys.T
    rows[:N, 2 * L] = 1
    rows[N, L] = 1
    return rows


def _perm_slots(digits_g, pad: int, beff: int):
    """Inverse permutation for one window group: digits_g (Wg, N) ->
    (src (pad, Wg * beff) int64, ok flag).  src[p, w * beff + b] is the row
    of the p-th point of bucket b in window w, or the sentinel N past the
    bucket's count.  One sort of the packed key digit << ibits | index
    (digit-major, index-minor: the JAX package's order), then bucket
    boundaries by searchsorted.  ok is False iff a nonzero-digit bucket holds
    more than pad points (bucket 0 has weight 0 and may overflow)."""
    Wg, N = digits_g.shape
    dev = digits_g.device
    ibits = max(1, (N - 1).bit_length())
    low = (1 << ibits) - 1
    skey = torch.sort((digits_g << ibits) | torch.arange(N, device=dev), dim=1).values
    bvals = (torch.arange(beff, dtype=I64, device=dev) << ibits).expand(Wg, beff).contiguous()
    first = torch.searchsorted(skey, bvals, side="left")
    # end of bucket b: the last key it can hold, (b << ibits) | low, so the
    # top bucket's bound never leaves the key range
    count = torch.searchsorted(skey, bvals | low, side="right") - first
    ok = count[:, 1:].max() <= pad
    order = skey & low
    p = torch.arange(pad, device=dev)[None, :, None]
    idx = (first[:, None, :] + p).clamp(max=N - 1).reshape(Wg, pad * beff)
    got = torch.gather(order, 1, idx).reshape(Wg, pad, beff)
    src = torch.where(p < count[:, None, :], got, N)
    return src.permute(1, 0, 2).reshape(pad, Wg * beff), ok


def _bucket_group_rows(rows, src, pad: int, Wg: int, beff: int) -> cv.PointVec:
    """One window group's weighted bucket sums (18, Wg) from the row table
    and inverse permutation: in-kernel gather and pad reduction, then the
    suffix-doubling weighting.

    K-way pad fold: when the group has fewer than _FOLD_COLS columns, slot
    (p, col) moves to (p // K, col * K + p % K), so K slices of the pad
    axis run side by side and the sequential reduction is K times shorter
    (at n = 16384 the top window's 128 columns x pad 384 become 1024
    columns x 48); the K partials per column then meet in a strided sum."""
    cols = Wg * beff
    nsent = rows.shape[0] - 1
    K = 1
    while cols * K * 2 <= _FOLD_COLS and K * 2 <= pad:
        K *= 2
    padq = (pad + K - 1) // K
    if padq * K > pad:
        fill = torch.full((padq * K - pad, cols), nsent, dtype=src.dtype, device=src.device)
        src = torch.cat([src, fill])
    if K > 1:
        src = src.reshape(padq, K, cols).transpose(1, 2).reshape(padq, cols * K)
    S = cv.PointVec(*(a.reshape(L, cols, K) for a in ck.bucket_accum(rows, src)))
    S = _strided_sum(S, K) if K > 1 else _first(S)
    return _suffix_weight(cv.PointVec(*(a.reshape(L, Wg, beff) for a in S)), beff)


def _expand_groups(pads: list[int], beffs: list[int]):
    """(pad, beff) runs split so each group's index matrix fits the budget."""
    out = []
    for w0, w1, beff, pad in _group_windows(pads, beffs):
        wc = max(1, _SCATTER_BUDGET_COLS // (beff * pad))
        for ws in range(w0, w1, wc):
            out.append((ws, min(ws + wc, w1), beff, pad))
    return out


def _rowperm_msm(points: cv.PointVec, scalars, c: int, pads: list[int], beffs: list[int], rows=None):
    """Row-permutation MSM: (point, ok flag), no host sync.  rows: an
    optional precomputed table, projective (64 lanes) or affine (40 lanes;
    the URS's `pp.gs_rows`); built from points when absent."""
    if rows is None:
        rows = rows_from_points(points)
    digits = _digits(scalars, c)
    Vs, oks = [], []
    for w0, w1, beff, pad in _expand_groups(pads, beffs):
        src, okv = _perm_slots(digits[w0:w1], pad, beff)
        V = _bucket_group_rows(rows, src, pad, w1 - w0, beff)
        Vs.append(cv.PointVec(*(a[:, :, None] for a in V)))
        oks.append(okv)
    acc = _horner_routes(_cat_groups(Vs), c)
    return cv.PointVec(acc.x[:, 0], acc.y[:, 0], acc.z[:, 0]), torch.stack(oks).all()


# -- entry points ----------------------------------------------------------------------


def _sortrows(n: int) -> bool:
    """Whether an n-point MSM takes the sort-payload pipeline: under the
    default setting, at widths of _SORTROWS_MIN and up (narrower ones take
    the row-permutation pipeline, as in the JAX package)."""
    return _impl() == "sortrows" and n >= _SORTROWS_MIN


def _true(device):
    return torch.ones((), dtype=torch.bool, device=device)


def msm_flagged(points: cv.PointVec, scalars, c: int | None = None, pads: list[int] | None = None,
                planes=None, rows=None):
    """MSM with PINNED pads and no host sync: (point, ok flag).  ok False
    means a bucket overflowed its pad and the point is unreliable (the
    caller then takes `_msm_measured`).  Without pads, widths up to
    _LADDER_MAX take the exact ladder.  planes / rows: the URS's
    precomputed pair-packed planes (sort-payload) or row table
    (row-permutation); each pipeline reads only its own, the staged one
    neither."""
    N = points.x.shape[1]
    if pads is None and N <= _LADDER_MAX:
        return msm_ladder(points, scalars), _true(scalars.device)
    if c is None:
        c = window_size(N)
    if pads is None:
        pads = pinned_pads(N, c)
    return _pipeline(points, scalars, c, pads, planes, rows)


def _pipeline(points: cv.PointVec, scalars, c: int, pads: list[int], planes, rows):
    """(point, ok) from the pipeline the setting selects, routed as the JAX
    package's msm_flagged: sort-payload from _SORTROWS_MIN points under
    "sortrows", row-permutation under "rowperm" and below it, staged
    otherwise (its pinned pads checked by _pads_ok; a window whose scatter
    matrix would pass the budget sends the MSM to msm(), which measures
    and chunks).  The budget is held against 2^c columns a pad slot, which
    is what stage 1 scatters: the JAX package holds beff * pad to it, and
    at c = 10 (n = 65,536) the top window's pinned pad of 5,120 passes that
    test but fails _bucket_sums' assertion (1,024 * 5,120 > 2^21)."""
    N = points.x.shape[1]
    beffs = _beffs(c)
    if _staged():
        if any((1 << c) * p > _SCATTER_BUDGET_COLS for p in pads):
            return msm(points, scalars, c), _true(scalars.device)
        digits = _digits(scalars, c)
        return _staged_msm(points, digits, c, pads, beffs), _pads_ok(digits, c, pads)
    if not _sortrows(N):
        return _rowperm_msm(points, scalars, c, pads, beffs, rows=rows)
    if planes is None:
        points, scalars = _pad_points(points, scalars, 8)
        planes = planes_from_points(points)
    elif planes.shape[1] % 8:
        raise ValueError("sort-payload planes need N % 8 == 0")
    (pt,), ok = _sortrows_msm(planes, scalars, c, pads, beffs)
    return pt, ok


def msm(points: cv.PointVec, scalars, c: int | None = None, planes=None, rows=None) -> cv.PointVec:
    """sum_i scalars_i * points_i.  Under "sortrows" and "rowperm": pinned
    pads first, and on the rare overflow the staged pipeline with pads
    measured from the digits; under the staged setting that measured
    pipeline at once (the JAX package's msm)."""
    N = points.x.shape[1]
    if c is None:
        c = window_size(N)
    if not _staged():
        pt, ok = msm_flagged(points, scalars, c=c, pads=pinned_pads(N, c), planes=planes, rows=rows)
        if bool(ok):
            return pt
    return _msm_measured(points, scalars, c)


# -- staged pipeline and measured pads ----------------------------------------------------
#
# The JAX package's staged backstop: stage 1 scatters each window's points
# into a (window, bucket x pad) identity matrix by their sort ranks and sums
# the pad axis (_bucket_sums_chunk); stages 2 to 4 weight the buckets and
# combine the windows (_weight_and_combine).  Every point op is the padd or
# pdbl kernel.


def _max_bucket_counts(digits, c: int):
    """Per-row most points in any nonzero-digit bucket: (R, N) -> (R,).
    Rows are windows, or (window, point chunk) pairs when a chunked run
    re-measures.  A scatter-add of ones: no host sync."""
    counts = torch.zeros((digits.shape[0], 1 << c), dtype=I64, device=digits.device)
    counts.scatter_add_(1, digits, torch.ones_like(digits))
    counts[:, 0] = 0
    return counts.max(1).values


def _pads_ok(digits, c: int, pads) -> torch.Tensor:
    """Device bool: every window's fullest nonzero bucket fits its pad."""
    pads = torch.tensor(list(pads), dtype=I64, device=digits.device)
    return (_max_bucket_counts(digits, c) <= pads).all()


def _measure_pads(digits, c: int, tag: str = "w") -> list[int]:
    """Per-row max nonzero-digit bucket counts (one device-to-host copy),
    rounded to pad classes.  tag names the JAX package's compile-cache
    entry; it does nothing here."""
    return [_round_pad(max(1, int(m))) for m in _max_bucket_counts(digits, c).cpu()]


def _measure_pad(digits, c: int, tag: str = "w") -> int:
    return max(_measure_pads(digits, c, tag))


def _bucket_sums_chunk(points: cv.PointVec, digits, c: int, pad: int):
    """Stage 1 for one window group: (Wc, N) digits -> bucket sums, a
    tuple of three (Wc, 18, B) coordinates.  Each row's digits are sorted
    (stably, as jnp.argsort); a point's rank in its bucket picks its slot,
    and the points are written into a (18, Wc, B * pad) identity matrix at
    (window, bucket * pad + slot) index pairs (never a flattened product,
    so no index overflows).  Ranks past pad - 1 share the last slot: only
    the weightless bucket 0 may overflow when the pads were measured.
    Then the complete-add tree over the pad axis."""
    Wc, N = digits.shape
    B = 1 << c
    dev = digits.device
    sd, order = torch.sort(digits, dim=1, stable=True)
    first = torch.searchsorted(sd, sd, side="left")
    rank = torch.arange(N, device=dev)[None] - first
    col = (sd * pad + rank.clamp(max=pad - 1)).reshape(Wc * N)
    widx = torch.arange(Wc, device=dev)[:, None].expand(Wc, N).reshape(Wc * N)
    M = cv.identity((Wc, B * pad), dev)
    for m, a in zip(M, points):
        m[:, widx, col] = a[:, order].reshape(L, Wc * N)
    S = cv.sum_points(cv.PointVec(*(m.reshape(L, Wc, B, pad) for m in M)), axis=2)  # (18, Wc, B)
    return tuple(a.movedim(0, 1) for a in S)


def _bucket_sums(points: cv.PointVec, digits, c: int, pad: int):
    """Stage 1: (W, N) digits -> (W, 18, B) bucket sums, windows grouped so
    each group's scatter matrix fits _SCATTER_BUDGET_COLS."""
    W = digits.shape[0]
    B = 1 << c
    assert B * pad <= _SCATTER_BUDGET_COLS, "caller must chunk points first"
    Wg = max(1, _SCATTER_BUDGET_COLS // (B * pad))
    outs = [_bucket_sums_chunk(points, digits[w0 : w0 + Wg], c, pad) for w0 in range(0, W, Wg)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _combine_sums(a, b):
    """Complete-add two (W, 18, B) partial bucket-sum stacks."""
    A = cv.PointVec(*(x.movedim(1, 0) for x in a))
    Bv = cv.PointVec(*(x.movedim(1, 0) for x in b))
    return tuple(x.movedim(0, 1) for x in cv.padd(A, Bv))


def _suffix_mask(xs, c: int):
    """Stage 2 as separate sums: suffix sums T_b = sum_{j >= b} S_j (so
    sum_{b >= 1} T_b = sum_b b S_b), bucket 0 set to the identity.
    (W, 18, B) -> (W, 18, B)."""
    B = 1 << c
    T = cv.PointVec(*(a.movedim(0, 1) for a in xs))  # (18, W, B)
    T = _shift_adds(T, c)
    dev = T.x.device
    T = cv.pselect(torch.arange(B, device=dev) >= 1, T, cv.identity(T.batch_shape, dev))
    return tuple(a.movedim(1, 0) for a in T)


def _window_reduce(xs):
    """Stage 3: the bucket axis tree-summed, (W, 18, B) -> (18, W)."""
    return tuple(cv.sum_points(cv.PointVec(*(a.movedim(0, 1) for a in xs)), axis=1))


def _horner_combine(xs, c: int) -> cv.PointVec:
    """Stage 4: Horner over the windows' points (18, W), msb window first:
    acc <- 2^c acc + T_w, one point."""
    acc = _horner_routes(cv.PointVec(*(a[:, :, None] for a in xs)), c)
    return cv.PointVec(acc.x[:, 0], acc.y[:, 0], acc.z[:, 0])


def _weight_and_combine(S, c: int) -> cv.PointVec:
    """Stages 2 to 4: (W, 18, B) bucket sums -> the suffix-doubling
    weighted sum of each window -> Horner over the windows."""
    B = S[0].shape[2]
    V = _suffix_weight(cv.PointVec(*(a.movedim(0, 1) for a in S)), B)  # (18, W)
    return _horner_combine(tuple(V), c)


def _staged_msm(points: cv.PointVec, digits, c: int, pads: list[int], beffs: list[int]) -> cv.PointVec:
    """The staged pipeline with a pad per run of windows sharing (beff,
    pad): stage 1 per run, stages 2 to 4 once over every window."""
    outs = [_bucket_sums(points, digits[w0:w1], c, pad) for w0, w1, _, pad in _group_windows(pads, beffs)]
    S = outs[0] if len(outs) == 1 else tuple(torch.cat([o[i] for o in outs]) for i in range(3))
    return _weight_and_combine(S, c)


def _msm_measured(points: cv.PointVec, scalars, c: int | None = None) -> cv.PointVec:
    """The staged pipeline with pads measured from the digits (one host
    copy): the backstop after a pinned-pad overflow under every setting,
    and the staged setting's msm.  When one window's scatter matrix would
    pass _SCATTER_BUDGET_COLS, the points go in K chunks (K doubling until
    each chunk's re-measured pad fits), whose bucket sums meet in complete
    adds; digits so skewed that 64 chunks do not fit restart at c = 3."""
    N = points.x.shape[1]
    assert scalars.shape == (L, N)
    if c is None:
        c = window_size(N)
    B = 1 << c
    W = num_windows(c)
    digits = _digits(scalars, c)
    pads = _measure_pads(digits, c)
    if all(B * p <= _SCATTER_BUDGET_COLS for p in pads):
        return _staged_msm(points, digits, c, pads, _beffs(c))
    pad = max(pads)
    if B * pad <= _SCATTER_BUDGET_COLS:
        return _weight_and_combine(_bucket_sums(points, digits, c, pad), c)
    K = 2
    while True:
        points, scalars = _pad_points(points, scalars, K)
        if points.x.shape[1] != digits.shape[1]:
            digits = _digits(scalars, c)
        Nc = digits.shape[1] // K
        padk = _measure_pad(digits.reshape(W * K, Nc), c, "k")
        if B * padk <= _SCATTER_BUDGET_COLS or Nc == 1:
            break
        if K >= 64 and c > 3:
            return _msm_measured(points, scalars, c=3)
        K *= 2
    S = None
    for k in range(K):
        lo, hi = k * Nc, (k + 1) * Nc
        Sk = _bucket_sums(cv.PointVec(*(a[:, lo:hi] for a in points)), digits[:, lo:hi], c, padk)
        S = Sk if S is None else _combine_sums(S, Sk)
    return _weight_and_combine(S, c)


# -- shape-classed and reference MSMs -------------------------------------------------------

_CLASS_MIN = 128


def _width_class(m: int) -> int:
    """The class ladder 128, 512, 2048, ...: the least class holding m."""
    cls = _CLASS_MIN
    while cls < m:
        cls *= 4
    return cls


def msm_classed(points: cv.PointVec, scalars, flags: list | None = None) -> cv.PointVec:
    """MSM with the width padded to its class and pinned pads of the class
    at c = 5, as the JAX package's (its open's former inner loop).  Up to
    _CLASS_MIN points: the exact ladder.  With a flags list, the pinned-pad
    flag (a device bool) is appended and the caller answers for an
    overflow; without, the pads are measured and merged with the pinned
    ones, so the result is always right.  Runs the staged pipeline, or the
    row-permutation one under "rowperm"."""
    m = points.x.shape[1]
    dev = scalars.device
    cls = _width_class(m)
    if cls <= _CLASS_MIN:
        pt = msm_ladder(points, scalars)
        if flags is not None:
            flags.append(_true(dev))
        return pt
    c = 5
    points, scalars = _pad_points(points, scalars, cls)
    pads = pinned_pads(cls, c)
    beffs = _beffs(c)
    if _impl() == "rowperm":
        pt, okv = _rowperm_msm(points, scalars, c, pads, beffs)
        if flags is not None:
            flags.append(okv)
            return pt
        if bool(okv):
            return pt
        return _msm_measured(points, scalars, c)
    digits = _digits(scalars, c)
    if flags is not None:
        flags.append(_pads_ok(digits, c, pads))
    else:
        pads = [max(p, q) for p, q in zip(pads, _measure_pads(digits, c, "cl"))]
    if any((1 << c) * p > _SCATTER_BUDGET_COLS for p in pads):
        return _msm_measured(points, scalars)
    return _staged_msm(points, digits, c, pads, beffs)


def msm_naive(points: cv.PointVec, scalars) -> cv.PointVec:
    """Reference binary-method MSM: per bit, msb first, one doubling and the
    tree sum of the points whose scalar has the bit set (255 doublings and
    about 255 N adds).  A slow independent check of the bucket pipelines."""
    N = points.x.shape[1]
    dev = scalars.device
    s = FR.canon(scalars)
    ident = cv.identity((N,), dev)
    acc = cv.identity((), dev)
    for i in range(NBITS):
        bit = NBITS - 1 - i
        acc = cv.pdbl(acc)
        sel = cv.pselect(((s[bit // 15] >> (bit % 15)) & 1).bool(), points, ident)
        acc = cv.padd(acc, cv.sum_points(sel, axis=0))
    return acc


# -- fixed-base MSMs over the URS -------------------------------------------------------
#
# urs: a PublicParams (gs_points, gs_planes, gs_rows).  These pick the
# pipeline and the URS table it reads, so the protocol layers never branch
# on the MSM setting.


def _urs_tables(urs, k: int, projective: bool) -> dict:
    """The table of the first k generators the selected pipeline reads
    (none for the staged one).  projective: 64-lane projective rows instead
    of 40-lane affine ones."""
    if _sortrows(k):
        return {"planes": urs.gs_planes(k)}
    if _staged():
        return {}
    return {"rows": urs.gs_rows(k, projective)}


def fixed_base_flagged(urs, scalars, projective: bool = False):
    """sum_i scalars_i G_i over the first k = scalars.shape[1] generators
    with pinned pads (the exact ladder up to _LADDER_MAX): (point, ok flag)."""
    k = scalars.shape[1]
    return msm_flagged(urs.gs_points(k), scalars, **_urs_tables(urs, k, projective))


def fixed_base(urs, scalars, projective: bool = False) -> cv.PointVec:
    """fixed_base_flagged, and on an overflow the staged `_msm_measured`
    over the generators, as the JAX package's msm(); under the staged
    setting above _LADDER_MAX points that measured MSM at once.  The
    prover's rounds and U read projective rows under the row-permutation
    setting, as the JAX package's (its msm() builds them from the points)."""
    k = scalars.shape[1]
    if not (_staged() and k > _LADDER_MAX):
        pt, ok = fixed_base_flagged(urs, scalars, projective)
        if bool(ok):
            return pt
    return _msm_measured(urs.gs_points(k), scalars)


def _split_routes(s_comb, route):
    """Dual-MSM scalars -> the L and R scalar vectors, each zero off its route."""
    zero = torch.zeros_like(s_comb)
    lo = (route == 0)[None]
    return torch.where(lo, s_comb, zero), torch.where(lo, zero, s_comb)


def fixed_base_pair(urs, scalars, route, safe: bool = False):
    """One IPA round's L and R over the first n generators: the MSMs of
    scalars over the points of route 0 and of route 1, ([L, R], ok flag).
    The sort-payload pipeline computes both in one pass at the half-width's
    window and pads; where fixed_base_many_flagged takes its exact ladder
    (up to _LADDER_MAX points outside the sort-payload pipeline) both are
    that one batched ladder; otherwise, and when safe (the re-run after an
    overflow), two fixed_base calls."""
    n = scalars.shape[1]
    if n > _LADDER_MAX and not safe and _sortrows(n):
        c = window_size(n // 2)
        return _sortrows_msm(urs.gs_planes(n), scalars, c, pinned_pads(n // 2, c), _beffs(c),
                             route=route, nroute=2)
    routes = _split_routes(scalars, route)
    if n <= _LADDER_MAX and not _sortrows(n):
        LR, ok = fixed_base_many_flagged(urs, torch.stack(routes, dim=1))
        return [cv.PointVec(*(a[:, i] for a in LR)) for i in range(2)], ok
    return [fixed_base(urs, e, projective=True) for e in routes], _true(scalars.device)


def fixed_base_many_flagged(urs, scalars_many):
    """K MSMs over the first n generators: scalars_many (18, K, n) ->
    (PointVec (18, K), ok flag).  Sort-payload: one K-fold MSM; up to
    _LADDER_MAX points: one batched ladder; row-permutation: one pinned-pad
    MSM per row, as the JAX package's check_device."""
    K, n = scalars_many.shape[1:]
    if _sortrows(n):
        c = window_size(n)
        return msm_many_flagged(urs.gs_planes(n), scalars_many, c, pinned_pads(n, c), _beffs(c))
    if n <= _LADDER_MAX:
        pts = cv.PointVec(*(a[:, None].expand(L, K, n) for a in urs.gs_points(n)))
        return msm_rows(pts, scalars_many), _true(scalars_many.device)
    outs = [fixed_base_flagged(urs, scalars_many[:, k]) for k in range(K)]
    comm = cv.PointVec(*(torch.stack([pt[i] for pt, _ in outs], dim=1) for i in range(3)))
    return comm, torch.stack([ok for _, ok in outs]).all()


def msm_ladder(points: cv.PointVec, scalars) -> cv.PointVec:
    """Exact windowed-ladder MSM (msm_rows at batch 1): no pads."""
    P1 = cv.PointVec(*(a[:, None, :] for a in points))
    R = msm_rows(P1, scalars[:, None, :])
    return cv.PointVec(R.x[:, 0], R.y[:, 0], R.z[:, 0])


def _window_digits4(s):
    """Canonical Fr limbs (18, *B) -> (64, *B) 4-bit window digits, msb
    window first (the top window holds bits 252..254)."""
    out = []
    for i in range(64):
        q, r = divmod(4 * (63 - i), 15)
        d = s[q] >> r
        if r > 11 and q + 1 < L:
            d = d | (s[q + 1] << (15 - r))
        out.append(d & 15)
    return torch.stack(out)


def msm_rows(points: cv.PointVec, scalars) -> cv.PointVec:
    """Batched independent small MSMs: points (18, B, M), scalars
    (18, B, M) -> one point per row, (18, B).

    4-bit windows: per-lane tables of 0..15 multiples, every window's
    lookups summed over M in one tree (all 64 windows at once), then a
    Horner combine acc <- 16 acc + S_w over the windows, msb first."""
    B, M = points.batch_shape
    dev = points.x.device
    tab = [cv.identity((B, M), dev), points]
    for _ in range(2, 16):
        tab.append(cv.padd(tab[-1], points))
    table = [torch.stack([t[i] for t in tab]) for i in range(3)]  # (16, 18, B, M)
    d = _window_digits4(FR.canon(scalars))  # (64, B, M)
    idx = d[:, None].expand(64, L, B, M)
    T = cv.PointVec(*(torch.gather(t, 0, idx).transpose(0, 1) for t in table))  # (18, 64, B, M)
    S = cv.sum_points(T, axis=2)  # (18, 64, B)
    acc = cv.PointVec(S.x[:, 0], S.y[:, 0], S.z[:, 0])
    for w in range(1, 64):
        acc = cv.pdbl(acc, 4)
        acc = cv.padd(acc, cv.PointVec(S.x[:, w], S.y[:, w], S.z[:, w]))
    return acc
