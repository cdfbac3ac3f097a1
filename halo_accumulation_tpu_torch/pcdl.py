"""PCDL: commitments, the IPA opening proof, succinct checks and full checks.

Counterpart of `halo_accumulation_tpu/pcdl.py` (the reference's pcdl.rs
commit :99, open :120, succinct_check :252, check :323):

  * Every Fiat-Shamir challenge of a succinct check depends only on proof
    data, so the transcript replays on the host and the group equation
    comes back as one MSM row (points, scalars) that must sum to the
    identity; many rows batch into one `msm_rows` call on the device.
  * `open_` takes the JAX package's two routes, under the JAX package's
    condition: the device transcript (`_open_device`) by default, at widths
    above 256 under the sort-payload MSM; the host transcript otherwise or
    under HALO_TPU_OPEN_DEVICE=0.  Both write the same proof bytes.  In
    each, a round's L and R are fixed-base MSMs with tensor-coefficient
    scalars over the URS.
      - Host transcript: the rounds hash on the host, one copy per round
        brings both points and both dot products over, and the basis never
        folds.  Under the sort-payload MSM one dual-output pass computes
        both points; under the row-permutation MSM, two MSMs
        (`msm.fixed_base_pair` chooses).
      - Device transcript: every round stays on the device - H' rides as
        two extra basis columns, the challenge is hashed on the card
        (`ck.rho_round`), and every four rounds the basis folds by 16
        (`msm.fold_basis`), so later rounds run at 1/16 of the width.  The
        whole open makes one device-to-host copy.
  * On the card the JAX package's single-dispatch programs are CUDA
    graphs (`runtime.graphed`): the device open (`_open_rounds`, its
    `ofd4`/`ofdF` segments) and the deciders' verdicts (`_verdicts`: row
    MSM, deferred n-point MSM, U equality; its `_deciders_fused`).
  * Under a mesh (parallel/msm_sharded.make_mesh), as in the JAX package:
    the batched checks' rows split over the ranks (rows_sharded),
    check_device's deferred MSM runs on msm_sharded, and open_ splits the
    fold's width (_open_sharded); every rank gets the single-device result.

Proof objects live on the host as canonical ints.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import hostops as H
from halo_accumulation_tpu_torch import pp as pp_mod
from halo_accumulation_tpu_torch import runtime
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, curve as cv, msm as msm_mod, poly as poly_mod
from halo_accumulation_tpu_torch.ops.field import FR, I64, L, ints_to_limb_array, limb_array_to_ints
from halo_accumulation_tpu_torch.utils import serialize as ser
from halo_accumulation_tpu_torch.utils import transcript as tr

Point = tuple | None  # host affine point: (x, y) ints or None for infinity


def point_to_host(P: cv.PointVec) -> Point:
    """One projective device point -> host affine ints (one copy)."""
    return cv.to_host(P)[0]


def _point_and_flag_to_host(P: cv.PointVec, ok):
    """One projective device point and a bool flag in ONE copy:
    (host affine point, bool)."""
    blob = torch.cat([P.x, P.y, P.z, ok.to(I64).reshape(1)]).cpu().numpy()
    x, y, z = limb_array_to_ints(blob[: 3 * L].reshape(3, L).T)
    return cv.affine_int(x, y, z), bool(blob[3 * L])


def host_msm(scalars, points) -> Point:
    """Tiny MSM on the host oracle (a handful of points)."""
    return H.p_msm(scalars, points)


@dataclass
class HPoly:
    """h(X) represented by its lg(n) + 1 challenges."""

    xis: list

    def eval(self, z: int) -> int:
        return poly_mod.h_eval_host(self.xis, z, F.R)

    def serialize(self) -> bytes:
        return ser.ser_scalar_vec(self.xis)


@dataclass
class EvalProof:
    """pi = (L, R, U, c, C_bar, w')."""

    Ls: list
    Rs: list
    U: Point
    c: int
    C_bar: Point | None
    w_prime: int | None

    def serialize(self) -> bytes:
        out = ser.ser_vec([ser.ser_point(P) for P in self.Ls])
        out += ser.ser_vec([ser.ser_point(P) for P in self.Rs])
        out += ser.ser_point(self.U)
        out += ser.ser_scalar(self.c)
        out += ser.ser_option(None if self.C_bar is None else ser.ser_point(self.C_bar))
        out += ser.ser_option(None if self.w_prime is None else ser.ser_scalar(self.w_prime))
        return out

    @classmethod
    def parse(cls, b: bytes) -> tuple["EvalProof", int]:
        """Parse one proof from the front of b: (proof, bytes used)."""
        off = 0

        def take(n):
            nonlocal off
            chunk = b[off : off + n]
            off += n
            return chunk

        def take_vec_points():
            n = int.from_bytes(take(8), "little")
            return [ser.deser_point(take(ser.POINT_BYTES)) for _ in range(n)]

        Ls = take_vec_points()
        Rs = take_vec_points()
        U = ser.deser_point(take(ser.POINT_BYTES))
        c = int.from_bytes(take(32), "little")
        C_bar = w_prime = None
        if take(1) == b"\x01":
            C_bar = ser.deser_point(take(ser.POINT_BYTES))
        if take(1) == b"\x01":
            w_prime = int.from_bytes(take(32), "little")
        return cls(Ls, Rs, U, c, C_bar, w_prime), off

    @classmethod
    def deserialize(cls, b: bytes) -> "EvalProof":
        return cls.parse(b)[0]


def _pad_pow2(coeffs, n: int):
    """Zero-pad (18, k) coefficients to the next power of two (<= n)."""
    k = coeffs.shape[1]
    t = 1
    while t < k:
        t *= 2
    t = min(t, n)
    if t > k:
        coeffs = torch.cat([coeffs, FR.zeros((t - k,), coeffs.device)], dim=1)
    return coeffs


def _check_degree(d: int, pp: pp_mod.PublicParams) -> int:
    """n = d + 1, which must be a power of two no larger than the URS: one
    bare assert, as the JAX package's open_ and device commits."""
    n = d + 1
    if n & (n - 1) or n > pp.n:
        raise AssertionError
    return n


def commit_device(coeffs, d: int, pp: pp_mod.PublicParams):
    """Non-hiding commitment left on the device: (point, ok flag) from the
    pinned-pad MSM over the URS's precomputed table."""
    n = _check_degree(d, pp)
    return msm_mod.fixed_base_flagged(pp, _pad_pow2(coeffs, n))


def commit(coeffs, d: int, w: int | None, pp: pp_mod.PublicParams) -> Point:
    """Pedersen commitment of a coefficient vector over G[0..d+1], plus w*S
    when hiding.  coeffs: (18, k) Fr tensor or a list of ints (k <= d + 1);
    up to 8 listed coefficients commit on the host."""
    n = d + 1  # the JAX package's commit asserts each check with its text
    if n & (n - 1):
        raise AssertionError("d+1 must be a power of two")
    if n > pp.n:
        raise AssertionError("degree exceeds URS size")
    if isinstance(coeffs, list):
        if len(coeffs) <= 8:
            C = host_msm(coeffs, pp.gs_host(len(coeffs)))
            return C if w is None else H.p_add(C, H.p_mul(w, pp.s))
        coeffs = FR.from_ints(coeffs, pp.device)
    coeffs = _pad_pow2(coeffs, n)
    # the pinned-pad MSM's point and flag come over in one copy; the rare
    # overflow takes the staged pipeline with measured pads
    C, ok = _point_and_flag_to_host(*msm_mod.fixed_base_flagged(pp, coeffs))
    if not ok:
        C = point_to_host(msm_mod._msm_measured(pp.gs_points(coeffs.shape[1]), coeffs))
    return C if w is None else H.p_add(C, H.p_mul(w, pp.s))


# -- the IPA opening proof ----------------------------------------------------------


def open_(rng, coeffs, C: Point, d: int, z: int, w: int | None, pp: pp_mod.PublicParams,
          _safe: bool = False, mesh=None, axis: str | None = None, v: int | None = None) -> EvalProof:
    """IPA opening proof of p(z) = v for the polynomial committed in C
    (pcdl.rs:120-242).  rng: a numpy Generator, drawn from exactly as the
    JAX prover draws (the hiding polynomial's k - 1 coefficients, then
    w_bar), so the same rng gives the same proof bytes.  coeffs: (18, k) Fr
    tensor or list of ints; hiding iff w is not None; v: p(z) when the
    caller knows it.

    The rounds take the device transcript (_open_device) under the JAX
    package's condition: sort-payload MSMs, n above 256, not _safe, and
    HALO_TPU_OPEN_DEVICE not "0" (the default is "1"); else the host
    transcript.  Pinned-pad flags stay on the device and are checked once
    at the end; on the astronomically rare overflow the proof is rebuilt
    with _safe=True (every MSM measures its pads), drawing fresh prover
    randomness, as the JAX package does.

    mesh: a 1-D DeviceMesh (parallel/msm_sharded.make_mesh) to split the
    width of the fold over its ranks (_open_sharded; the JAX package shards
    the width-n fold vectors and the URS the same way): every rank calls
    open_ with the same arguments, its rng in the same state, and gets the
    proof the single-device open writes, byte for byte.  A mesh takes the
    host transcript, as in the JAX package.  When the mesh's size does not
    divide n, every rank runs the single-device open instead, as
    check_device does.  axis: the mesh's dimension name (msm_sharded.AXIS)."""
    n = _check_degree(d, pp)
    if mesh is not None:
        from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

        assert axis in (None, sh.AXIS), f"the mesh's one dimension is {sh.AXIS!r}"
        if n % mesh.size():
            mesh = None
    dev = pp.device
    if isinstance(coeffs, list):
        coeffs = FR.from_ints(coeffs, dev)
    orig_coeffs = coeffs
    coeffs = _pad_pow2(coeffs, n)
    k = coeffs.shape[1]
    zl = FR.from_ints([z], dev)[:, 0]
    if v is None:
        v = FR.to_ints(poly_mod.eval_poly(coeffs, zl))[0]

    if w is not None:
        # p_bar = (X - z) * q with q uniform of degree k - 2
        qc = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(k - 1)]
        p_bar = _mul_by_linear(FR.from_ints(qc, dev), zl)
        w_bar = int.from_bytes(rng.bytes(40), "little") % F.R
        C_bar = commit(p_bar, d, w_bar, pp)
        a = tr.rho_0(ser.ser_point(C), ser.ser_scalar(z), ser.ser_scalar(v), ser.ser_point(C_bar))
        coeffs = _add_scaled(coeffs, p_bar, FR.from_ints([a], dev)[:, 0])
        w_prime = (w_bar * a + w) % F.R
        C_prime = H.p_add(H.p_add(C, H.p_mul(a, C_bar)), H.p_neg(H.p_mul(w_prime, pp.s)))
    else:
        C_bar, w_prime, C_prime = None, None, C

    xi = tr.rho_0(ser.ser_point(C_prime), ser.ser_scalar(z), ser.ser_scalar(v))
    H_prime = H.p_mul(xi, pp.h)

    # The lg(n) rounds, expansion-based: a width-n tensor-coefficient vector
    # t tracks the folded basis over the original URS, so L_i and R_i are
    # fixed-base MSMs with disjoint supports (_open_round_pre), and
    # U = <t_final, G>.  The fold itself is field-only.
    cs = coeffs
    if k < n:
        cs = torch.cat([cs, FR.zeros((n - k,), dev)], dim=1)
    if (mesh is None and n > msm_mod._LADDER_MAX and not _safe and msm_mod._sortrows(n) and H_prime is not None
            and os.environ.get("HALO_TPU_OPEN_DEVICE", "1") != "0"):
        return _open_device(rng, orig_coeffs, cs, C, d, z, w, pp, C_bar, w_prime, xi, H_prime)
    zs = poly_mod.powers(zl, n)
    if mesh is not None:
        proof = _open_sharded(cs, zs, xi, H_prime, pp, mesh, _safe)
        if proof is None:  # a pinned pad overflowed on some rank: every rank rebuilds
            return open_(rng, orig_coeffs, C, d, z, w, pp, _safe=True, mesh=mesh, axis=axis)
        return EvalProof(*proof, C_bar, w_prime)
    t = FR.from_int(1, (n,), dev)
    Ls, Rs, flags = [], [], []
    m = n // 2
    while m >= 1:
        s_comb, route, dot_l, dot_r = _open_round_pre(cs, zs, t, m)
        (Lp, Rp), okv = msm_mod.fixed_base_pair(pp, s_comb, route, safe=_safe)
        flags.append(okv)
        xi = _host_round(Lp, Rp, dot_l, dot_r, H_prime, xi, Ls, Rs)
        cs, zs, t = _open_round_fold(cs, zs, t, m, *_challenge_limbs(xi, dev))
        m //= 2

    if flags and not bool(torch.stack(flags).all()):
        # a pinned pad overflowed: rebuild the proof through measured pads
        return open_(rng, orig_coeffs, C, d, z, w, pp, _safe=True)
    # U = G^(lg n)[0] = <t_final, G>: t_final is h's coefficient vector
    U = point_to_host(msm_mod.fixed_base(pp, t, projective=True))
    c = FR.to_ints(cs[:, 0])[0]
    return EvalProof(Ls, Rs, U, c, C_bar, w_prime)


def _open_sharded(cs, zs, xi: int, H_prime, pp: pp_mod.PublicParams, mesh, safe: bool):
    """open_'s host-transcript rounds with the width split over the mesh's
    ranks.  Rank r holds lanes [r w, (r + 1) w), w = n / size, of the
    tensor-coefficient vector t and of the URS.  cs and zs, whose live
    prefix [0, 2m) halves every round, are held whole on every rank and
    folded there, as are both dot products: s_comb at a rank's lanes reads
    cs below 2m, and the fold reads lanes j and j + m below 2m, so no
    coefficient crosses ranks.  The round's arithmetic is the single-device
    open's (_open_round_pre and _open_round_fold at the rank's lane
    offset).  A round's exchange is the ranks' partial L and R (each
    rank's two MSMs over its slice of the URS), summed over the ranks by
    msm_sharded's all-gather and tree; U gathers t once and runs
    msm_sharded over the split URS.  -> (Ls, Rs, U, c), or None when a
    pinned pad overflowed on any rank (the flags are ANDed over the
    ranks)."""
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    n, dev = cs.shape[1], cs.device
    w = n // mesh.size()
    lo = mesh.get_local_rank(sh.AXIS) * w
    urs = pp_mod.PublicParams(w, pp.gs_x[:, lo : lo + w], pp.gs_y[:, lo : lo + w], pp.s, pp.h)
    t = FR.from_int(1, (w,), dev)
    Ls, Rs, flags = [], [], []
    m = n // 2
    while m >= 1:
        s_loc, route, dot_l, dot_r = _open_round_pre(cs, zs, t, m, lo)
        e = torch.stack(msm_mod._split_routes(s_loc, route), dim=1)  # (18, 2, w): L's, R's scalars
        part, ok = msm_mod.fixed_base_many_flagged(urs, e)
        if safe and not bool(ok):
            pts = [msm_mod._msm_measured(urs.gs_points(w), e[:, i]) for i in range(2)]
            part, ok = cv.PointVec(*(torch.stack([p[i] for p in pts], dim=1) for i in range(3))), msm_mod._true(dev)
        flags.append(ok)
        LR = sh.sum_over_ranks(part, mesh)
        xi = _host_round(cv.PointVec(*(a[:, 0] for a in LR)), cv.PointVec(*(a[:, 1] for a in LR)), dot_l, dot_r,
                         H_prime, xi, Ls, Rs)
        cs, zs, t = _open_round_fold(cs, zs, t, m, *_challenge_limbs(xi, dev), lo)
        m //= 2
    if flags and not bool(sh.all_true(torch.stack(flags).all(), mesh)):
        return None
    U = sh.msm_sharded(urs.gs_points(w), sh.gather_lanes(t, mesh), mesh)
    return Ls, Rs, point_to_host(U), FR.to_ints(cs[:, 0])[0]


def _host_round(Lp: cv.PointVec, Rp: cv.PointVec, dot_l, dot_r, H_prime, xi: int, Ls: list, Rs: list) -> int:
    """A host-transcript round's tail: one copy of its device outputs, L
    and R completed with the dot products' multiples of H' and appended to
    Ls and Rs, and the next challenge xi_{i+1} = rho_0(xi_i, L, R)."""
    Lph, Rph, dl, dr = _fetch_round(Lp, Rp, dot_l, dot_r)
    Ls.append(H.p_add(Lph, H.p_mul(dl, H_prime)))
    Rs.append(H.p_add(Rph, H.p_mul(dr, H_prime)))
    return tr.rho_0(ser.ser_scalar(xi), ser.ser_point(Ls[-1]), ser.ser_point(Rs[-1]))


def _challenge_limbs(xi: int, dev):
    """xi and its inverse as (18,) Fr limb vectors on dev."""
    return FR.from_ints([xi], dev)[:, 0], FR.from_ints([pow(xi, -1, F.R)], dev)[:, 0]


def _fetch_round(Lp: cv.PointVec, Rp: cv.PointVec, dot_l, dot_r):
    """One round's device outputs in ONE copy: both points (host affine)
    and both dot products (canonical ints)."""
    blob = torch.stack([Lp.x, Lp.y, Lp.z, Rp.x, Rp.y, Rp.z, dot_l, dot_r], dim=1).cpu().numpy()
    x1, y1, z1, x2, y2, z2, dl, dr = limb_array_to_ints(blob)
    return cv.affine_int(x1, y1, z1), cv.affine_int(x2, y2, z2), dl % F.R, dr % F.R


def _open_round_pre(cs, zs, t, m: int, lane0: int = 0):
    """Pre-fold quantities of one round at width n, half-width m (cs / zs
    lanes >= 2m are zero, t is dense), for t's lanes j in [lane0, lane0 +
    t.shape[1]) (all n by default; one rank's under a mesh):

      s_comb[j] = t[j] * c[(j mod m) + m]  if (j & m) == 0   (L's scalars)
                  t[j] * c[j mod m]        otherwise         (R's scalars)
      route[j]  = (j & m) != 0             (the output lane j feeds)
      dot_l     = <c_hi, z_lo>,  dot_r = <c_lo, z_hi>"""
    n = cs.shape[1]
    dev = cs.device
    i = torch.arange(n, device=dev)
    j = i[lane0 : lane0 + t.shape[1]]
    jm = j & (m - 1)
    lo = (j & m) == 0
    s_comb = FR.mul(t, torch.where(lo[None], cs[:, jm + m], cs[:, jm]))
    route = (~lo).to(torch.int64)
    mask = (i < m)[None]
    ip = (i + m).clamp(max=n - 1)
    zero = torch.zeros_like(cs)
    c_hi = torch.where(mask, cs[:, ip], zero)
    z_hi = torch.where(mask, zs[:, ip], zero)
    dot_l = FR.sum_along(FR.mul(c_hi, zs), 0)
    dot_r = FR.sum_along(FR.mul(torch.where(mask, cs, zero), z_hi), 0)
    return s_comb, route, dot_l, dot_r


def _open_round_fold(cs, zs, t, m: int, xi, xi_inv, lane0: int = 0):
    """Fold cs / zs with the round challenge (pcdl.rs:216-224) and absorb xi
    into t at bit lg(m), t's lanes starting at lane0 as in _open_round_pre;
    lanes >= m of cs / zs become zero."""
    n = cs.shape[1]
    i = torch.arange(n, device=cs.device)
    mask = (i < m)[None]
    ip = (i + m).clamp(max=n - 1)
    zero = torch.zeros_like(cs)
    c_new = torch.where(mask, FR.add(cs, poly_mod.scale(cs[:, ip], xi_inv)), zero)
    z_new = torch.where(mask, FR.add(zs, poly_mod.scale(zs[:, ip], xi)), zero)
    t_new = torch.where(((i[lane0 : lane0 + t.shape[1]] & m) != 0)[None], poly_mod.scale(t, xi), t)
    return c_new, z_new, t_new


_COLLAPSE_MIN = 2048  # collapse segments while the width is at least this (W / 16 >= 128)


def _open_device(rng, orig_coeffs, cs, C, d: int, z: int, w, pp: pp_mod.PublicParams, C_bar, w_prime,
                 xi0: int, H_prime) -> "EvalProof":
    """open_'s device-transcript rounds (JAX pcdl._open_device): every
    round, segment and the proof's assembly in one body (_open_rounds),
    on the card one CUDA graph per (URS, n) (runtime.graphed), then ONE
    copy of the whole proof to the host.  Proof bytes equal the host
    transcript's.  A pinned pad overflow, or a collapsed basis point at the
    identity, rebuilds the proof through open_(..., _safe=True), the host
    transcript with measured pads and fresh prover randomness."""
    n = d + 1
    # H' (its x twice, then its y twice), xi_0 and z: the open's one
    # host-to-device copy, into the graph's static input
    inputs = torch.from_numpy(ints_to_limb_array([H_prime[0]] * 2 + [H_prime[1]] * 2 + [xi0, z]))
    blob = runtime.graphed("open", (n, _COLLAPSE_MIN), functools.partial(_open_rounds, pp), (cs, inputs),
                           pp.device, holds=(pp,)).cpu().numpy()
    k = n.bit_length() - 1
    coords = blob[: 4 * L * k].reshape(k, 4, L)
    Uh = blob[4 * L * k : 4 * L * k + 3 * L].reshape(3, L)
    fl = blob[4 * L * k + 3 * L :].astype(bool)
    if not fl[-1]:
        return open_(rng, orig_coeffs, C, d, z, w, pp, _safe=True)

    def to_int(limbs) -> int:
        return sum(int(v) << (15 * i) for i, v in enumerate(limbs))

    def to_pt(x, y, inf) -> Point:
        return None if inf else (to_int(x), to_int(y))

    Ls = [to_pt(coords[i, 0], coords[i, 1], fl[2 * i]) for i in range(k)]
    Rs = [to_pt(coords[i, 2], coords[i, 3], fl[2 * i + 1]) for i in range(k)]
    return EvalProof(Ls, Rs, to_pt(Uh[0], Uh[1], fl[-2]), to_int(Uh[2]), C_bar, w_prime)


def _open_rounds(pp: pp_mod.PublicParams, cs, inputs):
    """The device open's body, no host copy: cs (18, n) the padded
    coefficients, inputs (18, 6) H'.x, H'.x, H'.y, H'.y, xi_0 and z.  The
    segments of _open_fold_device chained on the device: a collapse
    segment (four rounds, then the basis folded by 16) while the width is
    at least _COLLAPSE_MIN and more than four rounds are left, then the
    final segment.  -> the proof as one int64 vector: per round L.x, L.y,
    R.x, R.y (canonical limbs), U.x, U.y, c, then the infinity flags (L, R
    a round, then U) and the AND of every ok flag."""
    n = cs.shape[1]
    dev = cs.device
    # H' rides as two extra basis columns (scalars: the round's two dot
    # products, one per route), then six zero columns, so N % 8 == 0
    planes_ext = torch.cat([pp.gs_planes(n), msm_mod.planes_from_affine(inputs[:, 0:2], inputs[:, 2:4]),
                            torch.zeros((L, 6), dtype=I64, device=dev)], dim=1)
    xi = inputs[:, 4]
    zs = poly_mod.powers(inputs[:, 5], n)
    rounds, oks = [], []
    # Wc, the segment width, is kept apart from the limb width W: shadowing
    # W corrupted every proof of the JAX package once
    Wc, rounds_left = n, n.bit_length() - 1
    while Wc >= _COLLAPSE_MIN and rounds_left > 4:
        seg, planes_ext, cs, zs, xi, ok = _open_fold_device(planes_ext, cs, zs, xi, 4, *_dual_params(Wc))
        rounds += seg
        oks.append(ok)
        Wc //= 16
        rounds_left -= 4
    cU = msm_mod.window_size(Wc)
    seg, (Uax, Uay, Uinf, c0, ok) = _open_fold_device(
        planes_ext, cs, zs, xi, rounds_left, *_dual_params(Wc),
        finalize=(cU, msm_mod.pinned_pads(Wc, cU), msm_mod._beffs(cU)))
    rounds += seg
    oks.append(ok)
    flags = [f for r in rounds for f in (r[2], r[5])] + [Uinf, torch.stack(oks).all()]
    return torch.cat([torch.stack([torch.stack([r[i] for i in (0, 1, 3, 4)]) for r in rounds]).reshape(-1),
                      Uax, Uay, c0, torch.stack(flags).to(I64)])


def _dual_params(Wc: int):
    """The dual-route MSM's window, pinned pads and bucket sizes at segment
    width Wc: each route's support is Wc / 2 points."""
    c = msm_mod.window_size(max(Wc // 2, 1))
    return c, msm_mod.pinned_pads(max(Wc // 2, 1), c), msm_mod._beffs(c)


def _open_fold_device(planes_ext, cs, zs, xi, k: int, c_dual: int, pads_dual, beffs_dual, finalize=None):
    """k IPA rounds at segment width Wf = cs.shape[1], nothing copied to the
    host: per round one dual-route MSM over the extended basis (H' in two
    columns, the dot products as their scalars, so L and R come out
    whole), batch normalization, the challenge hashed on the device, its
    inverse on the device (finv), and the field-only fold.

    finalize None (a collapse segment, k = 4): afterwards the basis folds by
    16 with the segment's tensor coefficients (msm.fold_basis), so the next
    segment runs at Wf / 16.  -> (rounds, planes_ext', cs', zs', xi', ok).
    finalize (cU, padsU, beffsU): U = <t_final, basis> after the rounds.
    -> (rounds, (U.x, U.y, U infinity, c, ok)).
    rounds: per round (L.x, L.y, L inf, R.x, R.y, R inf), canonical limbs."""
    Wf = cs.shape[1]
    dev = cs.device
    t = FR.from_int(1, (Wf,), dev)
    tail_route = (torch.arange(8, device=dev) == 1).to(I64)  # H' by route, then the zero columns
    zeros6 = FR.zeros((6,), dev)
    rounds, oks = [], []
    for i in range(k):
        m = Wf >> (i + 1)
        s_comb, route, dot_l, dot_r = _open_round_pre(cs, zs, t, m)
        s_ext = torch.cat([s_comb, dot_l[:, None], dot_r[:, None], zeros6], dim=1)
        (Lp, Rp), okv = msm_mod._sortrows_msm(planes_ext, s_ext, c_dual, pads_dual, beffs_dual,
                                               route=torch.cat([route, tail_route]), nroute=2)
        ax, ay, inf = cv.to_affine(cv.PointVec(*(torch.stack([a, b], dim=1) for a, b in zip(Lp, Rp))))
        rnd = (ax[:, 0], ay[:, 0], inf[0], ax[:, 1], ay[:, 1], inf[1])
        xi = ck.rho_round(xi, *rnd)  # xi_{i+1} = rho_0(xi_i, L, R) (pcdl.rs:212), left on the device
        cs, zs, t = _open_round_fold(cs, zs, t, m, xi, FR.inv(xi))
        rounds.append(rnd)
        oks.append(okv)
    if finalize is not None:
        cU, padsU, beffsU = finalize
        t_ext = torch.cat([t, FR.zeros((8,), dev)], dim=1)
        (Up,), okU = msm_mod._sortrows_msm(planes_ext, t_ext, cU, padsU, beffsU)
        Uax, Uay, Uinf = cv.to_affine(cv.PointVec(*(a[:, None] for a in Up)))
        return rounds, (Uax[:, 0], Uay[:, 0], Uinf[0], FR.canon(cs[:, 0]), torch.stack(oks + [okU]).all())
    w2 = Wf // 16
    t16 = t.reshape(L, 16, w2)[:, :, 0]  # t[h * w2]: one coefficient per block of w2
    basis2, any_inf = msm_mod.fold_basis(planes_ext[:, :Wf], t16)
    planes2 = torch.cat([basis2, planes_ext[:, Wf:]], dim=1)
    return rounds, planes2, cs[:, :w2], zs[:, :w2], xi, torch.stack(oks).all() & ~any_inf


def _mul_by_linear(q, zl):
    """(X - z) * q(X) for coefficients q (18, k): (18, k + 1)."""
    zero = FR.zeros((1,), q.device)
    return FR.sub(torch.cat([zero, q], dim=1), torch.cat([poly_mod.scale(q, zl), zero], dim=1))


def _add_scaled(a, b, s):
    """a + s * b for coefficient tensors of equal length."""
    return FR.add(a, poly_mod.scale(b, s))


def succinct_check_parts(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """Host transcript replay of succinct_check.  Returns (HPoly, pts, scs):
    the check holds iff sum scs_i * pts_i is the identity, i.e.

        C' + (v - v') xi_0 H + sum(xi^-1 L + xi R) - c U == 0."""
    n = d + 1
    lg_n = n.bit_length() - 1
    if n & (n - 1):
        raise ValueError("d+1 is not a power of 2")
    if len(pi.Ls) != lg_n or len(pi.Rs) != lg_n:
        raise ValueError("proof length mismatch")
    if pi.C_bar is not None:
        a = tr.rho_0(ser.ser_point(C), ser.ser_scalar(z), ser.ser_scalar(v), ser.ser_point(pi.C_bar))
        C_prime = H.p_add(H.p_add(C, H.p_mul(a, pi.C_bar)), H.p_neg(H.p_mul(pi.w_prime, pp.s)))
    else:
        C_prime = C
    xi_0 = tr.rho_0(ser.ser_point(C_prime), ser.ser_scalar(z), ser.ser_scalar(v))
    xis = [xi_0]
    for i in range(lg_n):
        xis.append(tr.rho_0(ser.ser_scalar(xis[i]), ser.ser_point(pi.Ls[i]), ser.ser_point(pi.Rs[i])))
    h = HPoly(xis)
    v_prime = pi.c * h.eval(z) % F.R
    pts = [C_prime, pp.h] + pi.Ls + pi.Rs + [pi.U]
    scs = [1, (v - v_prime) * xi_0 % F.R]
    scs.extend(_batch_inv_host(xis[1:]))
    scs.extend(xis[1:])
    scs.append((-pi.c) % F.R)
    return h, pts, scs


def _batch_inv_host(vals):
    """Montgomery-trick batch inversion on host ints."""
    if not vals:
        return []
    pref = [1]
    for v in vals:
        pref.append(pref[-1] * v % F.R)
    inv = pow(pref[-1], -1, F.R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % F.R
        inv = inv * vals[i] % F.R
    return out


def rows_tensors(rows, device):
    """Host MSM rows [(pts, scs), ...] -> (PointVec (18, B, M), scalars
    (18, B, M)), short rows padded with identity points and zero scalars."""
    B = len(rows)
    M = max(len(p) for p, _ in rows)
    pts = [q for p, _ in rows for q in p + [None] * (M - len(p))]
    scs = [x for _, s in rows for x in s + [0] * (M - len(s))]
    P = cv.from_affine_ints(pts, device)
    return cv.PointVec(*(a.reshape(L, B, M) for a in P)), FR.from_ints(scs, device).reshape(L, B, M)


def _rows_and_isinf(P, s):
    return cv.is_identity(msm_mod.msm_rows(P, s))


def rows_sharded(rows, pp: pp_mod.PublicParams, mesh, axis: str | None = None, pow2: bool = True):
    """Identity verdicts of host MSM rows [(pts, scs)] split over a mesh's
    ranks: the rows padded with identity rows, to a power of two (pow2) and
    then to a multiple of the mesh's size, as the JAX package pads them;
    each rank runs the row MSM on its contiguous B / size rows and the
    verdicts are all-gathered: (B,) bool on every rank, B >= len(rows), the
    padding rows True."""
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    assert axis in (None, sh.AXIS), f"the mesh's one dimension is {sh.AXIS!r}"
    nd, r = mesh.size(), mesh.get_local_rank(sh.AXIS)
    B = 1 << (len(rows) - 1).bit_length() if pow2 else len(rows)
    B = nd * -(-B // nd)
    b = B // nd
    mine = (rows + [([None], [0])] * (B - len(rows)))[r * b : (r + 1) * b]
    return sh.gather_rows(_rows_and_isinf(*rows_tensors(mine, pp.device)), mesh)


def succinct_check_batch_device(checks, pp: pp_mod.PublicParams, mesh=None, axis: str | None = None):
    """Host transcript replays + one batched row MSM, verdict left on the
    device: (parts, ok (B,) bool) with parts[b] = (HPoly, pts, scs).
    mesh: the rows split over its ranks (rows_sharded), the (B,) verdicts,
    padding rows included, on every rank; every rank must call it."""
    parts = [succinct_check_parts(C, d, z, v, pi, pp) for (C, d, z, v, pi) in checks]
    rows = [(p[1], p[2]) for p in parts]
    if mesh is not None:
        return parts, rows_sharded(rows, pp, mesh, axis)
    return parts, _rows_and_isinf(*rows_tensors(rows, pp.device))


def succinct_check_batch(checks, pp: pp_mod.PublicParams, mesh=None, axis: str | None = None):
    """Many succinct checks in one device call: [(HPoly, U)], or ValueError
    naming the first failing batch index.  mesh: the rows split over its
    ranks; every rank raises the same error."""
    parts, R = succinct_check_batch_device(checks, pp, mesh, axis)
    ok = R.cpu().tolist()
    for b in range(len(parts)):
        if not ok[b]:
            raise ValueError(f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})")
    return [(p[0], checks[b][4].U) for b, p in enumerate(parts)]


def succinct_check(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """O(lg d) proof check: (HPoly, U) or ValueError."""
    (res,) = succinct_check_batch([(C, d, z, v, pi)], pp)
    return res


def _deferred(xis, U: cv.PointVec, pp: pp_mod.PublicParams):
    """U_k == Commit(h_k) for the challenges xis (18, K, lg n + 1) and the
    points U (18, K), AND the pinned-pad flag: (K,) bool.  The K n-point
    MSMs run batched under the sort-payload pipeline, their digits cut
    straight from xis by the h_digits kernel; the row-permutation one
    commits each expanded h on its own (`msm.fixed_base_h_flagged`)."""
    comm, flag = msm_mod.fixed_base_h_flagged(pp, xis)
    return cv.peq(comm, U) & flag


def _verdicts(pp: pp_mod.PublicParams, Px, Py, Pz, s, xis, Ux, Uy, Uz):
    """The verdict graph's body: each MSM row's identity check (B,), the
    last K = xis.shape[1] of them ANDed with _deferred(xis, U)."""
    ok = _rows_and_isinf(cv.PointVec(Px, Py, Pz), s)
    K = xis.shape[1]
    return torch.cat([ok[: ok.shape[0] - K], ok[ok.shape[0] - K :] & _deferred(xis, cv.PointVec(Ux, Uy, Uz), pp)])


def verdicts_device(rows, hs: list[HPoly], Us: list[Point], d: int, pp: pp_mod.PublicParams, graph: bool):
    """Device verdicts of host MSM rows [(pts, scs)] whose last K = len(hs)
    rows are full checks at degree d: (B,) bool, row b's sum is the
    identity, the last K ANDed with U_k == Commit(h_k) and the pinned-pad
    flag.  Left on the device.  graph: run as one CUDA graph on the card,
    keyed by (B, M, K, n) and the URS (the JAX package's fused deciders);
    else eagerly.  Both take the same inputs, built on the host and copied
    over."""
    n = _check_degree(d, pp)
    P, s = rows_tensors(rows, "cpu")
    xis = FR.from_ints([x for h in hs for x in h.xis]).reshape(L, len(hs), -1)
    args = (*P, s, xis, *cv.from_affine_ints(Us))
    body = functools.partial(_verdicts, pp)
    if not graph:
        return body(*(a.to(pp.device) for a in args))
    return runtime.graphed("verdicts", (*s.shape[1:], len(hs), n), body, args, pp.device, holds=(pp,))


def check_many_device(checks, pp: pp_mod.PublicParams):
    """Full checks of K claims [(C, d, z, v, pi)] at one degree with the
    verdicts left on the device: (K,) bool, each the succinct row equation
    AND U == Commit(h) AND the pinned-pad flag; one CUDA graph on the card
    under the sort-payload MSM (the JAX package's _deciders_fused).  Raises
    ValueError on host-checkable malformations (proof length)."""
    parts = [succinct_check_parts(*chk, pp) for chk in checks]
    return verdicts_device([(p[1], p[2]) for p in parts], [p[0] for p in parts], [chk[4].U for chk in checks],
                           checks[0][1], pp, graph=msm_mod._impl() == "sortrows")


def check_device(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams,
                 mesh=None, axis: str | None = None):
    """Full check of one claim with the verdict left on the device.
    mesh: a 1-D DeviceMesh (parallel/msm_sharded.make_mesh) to split the
    deferred n-point MSM over its ranks, as the JAX package's check_device
    does when its size divides n; every rank must call it, and each gets
    the verdict.  Under a mesh whose size does not divide n, every rank
    runs the single-device check.  axis: the mesh's dimension name
    (msm_sharded.AXIS)."""
    if mesh is None or (d + 1) % mesh.size():
        return check_many_device([(C, d, z, v, pi)], pp)[0]
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    assert axis in (None, sh.AXIS), f"the mesh's one dimension is {sh.AXIS!r}"
    h, pts, scs = succinct_check_parts(C, d, z, v, pi, pp)
    ok_row = _rows_and_isinf(*rows_tensors([(pts, scs)], pp.device))[0]
    hc = _pad_pow2(_h_coeffs(h, pp.device), d + 1)
    k = max(hc.shape[1], mesh.size())
    if hc.shape[1] < k:
        hc = torch.cat([hc, FR.zeros((k - hc.shape[1],), pp.device)], dim=1)
    comm = sh.msm_sharded(sh.shard_points(pp.gs_points(k), mesh), hc, mesh)
    U = cv.from_affine_ints([pi.U], pp.device)
    return ok_row & cv.peq(comm, cv.PointVec(U.x[:, 0], U.y[:, 0], U.z[:, 0]))


def check(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """Full check: succinct check + the deferred n-point MSM.  On a False
    device verdict, re-verifies through the measured-pad path before
    rejecting (rules out a pinned-pad overflow)."""
    if not bool(check_device(C, d, z, v, pi, pp)):
        recheck(C, d, z, v, pi, pp)


def recheck(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """The tail of check() after a False device verdict: the succinct check
    alone (raises on a bad row equation), then U against a commit whose MSM
    measures its pads.  Returns normally when the verdict was a pinned-pad
    overflow; the batched deciders call it directly for a False verdict."""
    h, U = succinct_check(C, d, z, v, pi, pp)
    if commit(_h_coeffs(h, pp.device), d, None, pp) != U:
        raise ValueError("U != CM.Commit(ck, h_vec)")


def _h_coeffs(h: HPoly, device):
    return poly_mod.tensor_h_coeffs(FR.from_ints(h.xis, device))
