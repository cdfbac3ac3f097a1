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
  * Both finish with suffix-doubling bucket weighting and a Horner window
    combine.  Zero digits go to bucket 0, which has weight 0: zero-padded
    scalar vectors cost almost nothing on the sort-payload path.
  * Pads (the most points a bucket may hold) are PINNED per size class with
    a device validity flag; on the rare overflow `msm` re-runs the same
    pipeline with pads measured from the digits.
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
# The same for one row-permutation group's index matrix (the JAX package's
# scatter budget; the port never materializes the gathered rows).
_SCATTER_BUDGET_COLS = 1 << 21
_SORTROWS_MIN = 128  # narrower MSMs take the row-permutation pipeline
_LADDER_MAX = 256  # unpadded MSMs this narrow take the exact ladder
# Column width the K-way pad fold fills (the JAX package's g = 1024).
_FOLD_COLS = 1024


def _impl() -> str:
    """The bucket pipeline HALO_TPU_MSM_IMPL selects: "sortrows" (default)
    or "rowperm".  The JAX package's third value, "staged", is not ported."""
    impl = os.environ.get("HALO_TPU_MSM_IMPL", "sortrows")
    if impl == "staged":
        raise NotImplementedError(
            "HALO_TPU_MSM_IMPL=staged is not ported yet (ROADMAP.md, queue 1: backstop MSM pipelines)")
    if impl not in ("sortrows", "rowperm"):
        raise ValueError(f"HALO_TPU_MSM_IMPL={impl!r}: expected 'sortrows' or 'rowperm'")
    return impl


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
    the row-permutation pipeline, as in the JAX package).  The one reader
    of HALO_TPU_MSM_IMPL."""
    return _impl() == "sortrows" and n >= _SORTROWS_MIN


def _true(device):
    return torch.ones((), dtype=torch.bool, device=device)


def msm_flagged(points: cv.PointVec, scalars, c: int | None = None, pads: list[int] | None = None,
                planes=None, rows=None):
    """MSM with PINNED pads and no host sync: (point, ok flag).  ok False
    means a bucket overflowed its pad and the point is unreliable (msm()
    then re-runs with measured pads).  Without pads, widths up to
    _LADDER_MAX take the exact ladder.  planes / rows: the URS's
    precomputed pair-packed planes (sort-payload) or row table
    (row-permutation); each pipeline reads only its own."""
    N = points.x.shape[1]
    if pads is None and N <= _LADDER_MAX:
        return msm_ladder(points, scalars), _true(scalars.device)
    if c is None:
        c = window_size(N)
    if pads is None:
        pads = pinned_pads(N, c)
    return _pipeline(points, scalars, c, pads, planes, rows)


def _pipeline(points: cv.PointVec, scalars, c: int, pads: list[int], planes, rows):
    """(point, ok) from the pipeline `_sortrows` selects."""
    N = points.x.shape[1]
    if not _sortrows(N):
        return _rowperm_msm(points, scalars, c, pads, _beffs(c), rows=rows)
    if planes is None:
        points, scalars = _pad_points(points, scalars, 8)
        planes = planes_from_points(points)
    elif planes.shape[1] % 8:
        raise ValueError("sort-payload planes need N % 8 == 0")
    (pt,), ok = _sortrows_msm(planes, scalars, c, pads, _beffs(c))
    return pt, ok


def _measure_pads(digits, c: int) -> list[int]:
    """Per-window max nonzero-digit bucket counts, rounded to pad classes."""
    W, N = digits.shape
    B = 1 << c
    rows = torch.arange(W, device=digits.device)[:, None] * B
    counts = torch.bincount((digits + rows).reshape(-1), minlength=W * B).reshape(W, B)
    counts[:, 0] = 0
    return [_round_pad(max(1, int(m))) for m in counts.max(1).values.cpu()]


def _msm_measured(points: cv.PointVec, scalars, c: int | None = None, planes=None, rows=None):
    """The selected pipeline with pads measured from the digits (one host
    sync): the backstop after a pinned-pad overflow."""
    if c is None:
        c = window_size(points.x.shape[1])
    pt, ok = _pipeline(points, scalars, c, _measure_pads(_digits(scalars, c), c), planes, rows)
    assert bool(ok), "measured pads cover every bucket"
    return pt


def msm(points: cv.PointVec, scalars, c: int | None = None, planes=None, rows=None) -> cv.PointVec:
    """sum_i scalars_i * points_i: pinned pads first; on the rare overflow,
    one re-run of the same pipeline with pads measured from the digits."""
    N = points.x.shape[1]
    if c is None:
        c = window_size(N)
    pt, ok = msm_flagged(points, scalars, c=c, pads=pinned_pads(N, c), planes=planes, rows=rows)
    if bool(ok):
        return pt
    return _msm_measured(points, scalars, c, planes=planes, rows=rows)


# -- fixed-base MSMs over the URS -------------------------------------------------------
#
# urs: a PublicParams (gs_points, gs_planes, gs_rows).  These pick the
# pipeline and the URS table it reads, so the protocol layers never branch
# on the MSM setting.


def _urs_tables(urs, k: int, projective: bool) -> dict:
    """The table of the first k generators the selected pipeline reads.
    projective: 64-lane projective rows instead of 40-lane affine ones."""
    if _sortrows(k):
        return {"planes": urs.gs_planes(k)}
    return {"rows": urs.gs_rows(k, projective)}


def fixed_base_flagged(urs, scalars, projective: bool = False):
    """sum_i scalars_i G_i over the first k = scalars.shape[1] generators
    with pinned pads (the exact ladder up to _LADDER_MAX): (point, ok flag)."""
    k = scalars.shape[1]
    return msm_flagged(urs.gs_points(k), scalars, **_urs_tables(urs, k, projective))


def fixed_base(urs, scalars, projective: bool = False) -> cv.PointVec:
    """fixed_base_flagged, re-run with measured pads on an overflow.  The
    prover's rounds and U read projective rows under the row-permutation
    setting, as the JAX package's (its msm() builds them from the points)."""
    pt, ok = fixed_base_flagged(urs, scalars, projective)
    if bool(ok):
        return pt
    k = scalars.shape[1]
    return _msm_measured(urs.gs_points(k), scalars, **_urs_tables(urs, k, projective))


def _split_routes(s_comb, route):
    """Dual-MSM scalars -> the L and R scalar vectors, each zero off its route."""
    zero = torch.zeros_like(s_comb)
    lo = (route == 0)[None]
    return torch.where(lo, s_comb, zero), torch.where(lo, zero, s_comb)


def fixed_base_pair(urs, scalars, route, safe: bool = False):
    """One IPA round's L and R over the first n generators: the MSMs of
    scalars over the points of route 0 and of route 1, ([L, R], ok flag).
    The sort-payload pipeline computes both in one pass at the half-width's
    window and pads; otherwise, and when safe (the re-run after an
    overflow), two fixed_base calls."""
    n = scalars.shape[1]
    if n > _LADDER_MAX and not safe and _sortrows(n):
        c = window_size(n // 2)
        return _sortrows_msm(urs.gs_planes(n), scalars, c, pinned_pads(n // 2, c), _beffs(c),
                             route=route, nroute=2)
    return [fixed_base(urs, e, projective=True) for e in _split_routes(scalars, route)], _true(scalars.device)


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
