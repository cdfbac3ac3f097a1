"""Multi-scalar multiplication (Pippenger), sort-payload form, in PyTorch.

Counterpart of the verifier-path MSMs of `halo_accumulation_tpu/ops/msm.py`:

  * `_sortrows_msm` / `msm_flagged` / `msm_many_flagged`: the sort-payload
    Pippenger.  Per window the point coordinate planes are sorted along with
    the digit key, bucket boundaries come from searchsorted, buckets expand
    with 8-row-aligned block gathers, and the masked bucket kernel
    (ops/cuda_kernels.bucket_masked) sums each bucket, masking the ragged
    block edges by a per-column (off, len) word.  Suffix-doubling weighting
    and a Horner window combine finish the MSM.
  * Zero digits go to bucket 0, which has weight 0 and is never gathered:
    zero-padded scalar vectors cost almost nothing.
  * Pads (the most points a bucket may hold) are PINNED per size class with
    a device validity flag; on the rare overflow `msm` re-runs with pads
    measured from the digits.
  * `msm_rows`: many small independent MSMs, one per row, by a 4-bit
    windowed double-and-add (the batched succinct checks).

There is no jit here, so shapes need no padding to size classes: every call
runs eagerly at its exact width.
"""

from __future__ import annotations

import math

import torch

from halo_accumulation_tpu_torch import fields as _fields
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
from halo_accumulation_tpu_torch.ops import curve as cv
from halo_accumulation_tpu_torch.ops.field import FR, I64, L

NBITS = 255
# Most point columns (window group x buckets x pad) one sorted group may
# gather at once; larger window runs are split into several groups.
_SORT_BUDGET_COLS = 1 << 24
_SORTROWS_MIN = 128  # narrower MSMs take the exact ladder


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


def _suffix_weight(S: cv.PointVec, beff: int) -> cv.PointVec:
    """sum_{b >= 1} b * S_b per window: (18, Wg, beff) -> (18, Wg), by two
    suffix-doubling passes (the second after masking bucket 0)."""
    Wg = S.x.shape[1]
    dev = S.x.device
    if beff == 1:
        return cv.identity((Wg,), dev)
    ident = cv.identity((Wg, beff), dev)
    lgB = beff.bit_length() - 1

    def shift_add(T, i):
        sh = 1 << i
        shifted = cv.PointVec(*(torch.cat([a[:, :, sh:], ia[:, :, :sh]], dim=2) for a, ia in zip(T, ident)))
        return cv.padd(T, shifted)

    T = S
    for i in range(lgB):
        T = shift_add(T, i)
    T = cv.pselect(torch.arange(beff, device=dev) >= 1, T, ident)
    for i in range(lgB):
        T = shift_add(T, i)
    return cv.PointVec(T.x[:, :, 0], T.y[:, :, 0], T.z[:, :, 0])


def _sorted_group(planes, digits_g, pad: int, beff: int, nroute: int = 1):
    """One window group's weighted sums from a payload sort:
    (PointVec (18, Wg, nroute), ok flag).  digits_g: (Wg, N) in
    [0, nroute * beff); N a multiple of 8."""
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
        for _ in range(c):
            acc = cv.pdbl(acc)
        acc = cv.padd(acc, cv.PointVec(V.x[:, w], V.y[:, w], V.z[:, w]))
    return acc


def _cat_groups(Vs):
    return cv.PointVec(*(torch.cat([v[i] for v in Vs], dim=1) for i in range(3)))


def _sortrows_msm(planes, scalars, c: int, pads: list[int], beffs: list[int]):
    """Sort-payload MSM: (point, ok flag), no host sync.  planes: (18, N)
    pair-packed affine or (54, N) projective; N a multiple of 8."""
    digits = _digits(scalars, c)
    Vs, oks = [], []
    for w0, w1, beff, pad in _expand_groups_sorted(pads, beffs):
        V, okv = _sorted_group(planes, digits[w0:w1], pad, beff)
        Vs.append(V)
        oks.append(okv)
    acc = _horner_routes(_cat_groups(Vs), c)
    return cv.PointVec(acc.x[:, 0], acc.y[:, 0], acc.z[:, 0]), torch.stack(oks).all()


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


def msm_flagged(points: cv.PointVec, scalars, c: int | None = None, pads: list[int] | None = None,
                planes=None):
    """MSM with PINNED pads and no host sync: (point, ok flag).  ok False
    means a bucket overflowed its pad and the point is unreliable (msm()
    then re-runs with measured pads).  planes: precomputed coordinate
    planes (the URS's pair-packed planes on the fixed-base paths)."""
    N = points.x.shape[1]
    if N < _SORTROWS_MIN or (pads is None and N <= 256):
        return msm_ladder(points, scalars), torch.ones((), dtype=torch.bool, device=scalars.device)
    if c is None:
        c = window_size(N)
    if pads is None:
        pads = pinned_pads(N, c)
    if planes is None:
        points, scalars = _pad_points(points, scalars, 8)
        planes = planes_from_points(points)
    elif planes.shape[1] % 8:
        raise ValueError("sort-payload planes need N % 8 == 0")
    return _sortrows_msm(planes, scalars, c, pads, _beffs(c))


def _measure_pads(digits, c: int) -> list[int]:
    """Per-window max nonzero-digit bucket counts, rounded to pad classes."""
    W, N = digits.shape
    B = 1 << c
    rows = torch.arange(W, device=digits.device)[:, None] * B
    counts = torch.bincount((digits + rows).reshape(-1), minlength=W * B).reshape(W, B)
    counts[:, 0] = 0
    return [_round_pad(max(1, int(m))) for m in counts.max(1).values.cpu()]


def msm(points: cv.PointVec, scalars, c: int | None = None, planes=None) -> cv.PointVec:
    """sum_i scalars_i * points_i: pinned pads first; on the rare overflow,
    one re-run of the sort-payload MSM with pads measured from the digits."""
    N = points.x.shape[1]
    if c is None:
        c = window_size(N)
    pt, ok = msm_flagged(points, scalars, c=c, pads=pinned_pads(N, c), planes=planes)
    if bool(ok):
        return pt
    if planes is None:
        points, scalars = _pad_points(points, scalars, 8)
        planes = planes_from_points(points)
    pads = _measure_pads(_digits(scalars, c), c)
    pt, ok = _sortrows_msm(planes, scalars, c, pads, _beffs(c))
    assert bool(ok), "measured pads cover every bucket"
    return pt


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
        for _ in range(4):
            acc = cv.pdbl(acc)
        acc = cv.padd(acc, cv.PointVec(S.x[:, w], S.y[:, w], S.z[:, w]))
    return acc
