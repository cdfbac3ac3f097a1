"""PCDL, verifier side: commitments, succinct checks and full checks.

Counterpart of the verifier half of `halo_accumulation_tpu/pcdl.py`
(the reference's pcdl.rs commit :99, succinct_check :252, check :323).
Every Fiat-Shamir challenge of a succinct check depends only on proof
data, so the transcript replays on the host and the group equation comes
back as one MSM row (points, scalars) that must sum to the identity; many
rows batch into one `msm_rows` call on the device.  Proof objects live on
the host as canonical ints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import hostops as H
from halo_accumulation_tpu_torch import pp as pp_mod
from halo_accumulation_tpu_torch.ops import curve as cv, msm as msm_mod, poly as poly_mod
from halo_accumulation_tpu_torch.ops.field import FR, L
from halo_accumulation_tpu_torch.utils import serialize as ser
from halo_accumulation_tpu_torch.utils import transcript as tr

Point = tuple | None  # host affine point: (x, y) ints or None for infinity


def point_to_host(P: cv.PointVec) -> Point:
    """One projective device point -> host affine ints (one copy)."""
    return cv.to_host(P)[0]


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


def commit_device(coeffs, d: int, pp: pp_mod.PublicParams):
    """Non-hiding commitment left on the device: (point, ok flag) from the
    pinned-pad MSM over the URS's pair-packed planes."""
    n = d + 1
    if n & (n - 1) or n > pp.n:
        raise ValueError("d + 1 must be a power of two no larger than the URS")
    coeffs = _pad_pow2(coeffs, n)
    k = coeffs.shape[1]
    planes = pp.gs_planes(k) if k >= msm_mod._SORTROWS_MIN else None
    return msm_mod.msm_flagged(pp.gs_points(k), coeffs, planes=planes)


def commit(coeffs, d: int, w: int | None, pp: pp_mod.PublicParams) -> Point:
    """Pedersen commitment of a coefficient vector over G[0..d+1], plus w*S
    when hiding.  coeffs: (18, k) Fr tensor or a list of ints (k <= d + 1);
    up to 8 listed coefficients commit on the host."""
    n = d + 1
    if n & (n - 1) or n > pp.n:
        raise ValueError("d + 1 must be a power of two no larger than the URS")
    if isinstance(coeffs, list):
        if len(coeffs) <= 8:
            C = host_msm(coeffs, pp.gs_host(len(coeffs)))
            return C if w is None else H.p_add(C, H.p_mul(w, pp.s))
        coeffs = FR.from_ints(coeffs, pp.device)
    coeffs = _pad_pow2(coeffs, n)
    k = coeffs.shape[1]
    pt, ok = commit_device(coeffs, d, pp)
    if bool(ok):
        C = point_to_host(pt)
    else:
        planes = pp.gs_planes(k) if k >= msm_mod._SORTROWS_MIN else None
        C = point_to_host(msm_mod.msm(pp.gs_points(k), coeffs, planes=planes))
    return C if w is None else H.p_add(C, H.p_mul(w, pp.s))


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


def succinct_check_batch_device(checks, pp: pp_mod.PublicParams):
    """Host transcript replays + one batched row MSM, verdict left on the
    device: (parts, ok (B,) bool) with parts[b] = (HPoly, pts, scs)."""
    parts = [succinct_check_parts(C, d, z, v, pi, pp) for (C, d, z, v, pi) in checks]
    P, s = rows_tensors([(p[1], p[2]) for p in parts], pp.device)
    return parts, _rows_and_isinf(P, s)


def succinct_check_batch(checks, pp: pp_mod.PublicParams):
    """Many succinct checks in one device call: [(HPoly, U)], or ValueError
    naming the first failing batch index."""
    parts, R = succinct_check_batch_device(checks, pp)
    ok = R.cpu().tolist()
    for b in range(len(parts)):
        if not ok[b]:
            raise ValueError(f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})")
    return [(p[0], checks[b][4].U) for b, p in enumerate(parts)]


def succinct_check(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """O(lg d) proof check: (HPoly, U) or ValueError."""
    (res,) = succinct_check_batch([(C, d, z, v, pi)], pp)
    return res


def deferred_device(hs: list[HPoly], Us: list[Point], d: int, pp: pp_mod.PublicParams):
    """The deciders' deferred checks U == Commit(h coefficients) for K
    checks at one degree, left on the device: (K,) bool, AND the pinned-pad
    flag.  The K h expansions and the K n-point MSMs run batched."""
    n = d + 1
    if n & (n - 1) or n > pp.n:
        raise ValueError("d + 1 must be a power of two no larger than the URS")
    K = len(hs)
    xis = FR.from_ints([x for h in hs for x in h.xis], pp.device)
    hcs = poly_mod.tensor_h_coeffs(xis.reshape(L, K, -1))  # (18, K, n)
    if n >= msm_mod._SORTROWS_MIN:
        c = msm_mod.window_size(n)
        comm, flag = msm_mod.msm_many_flagged(
            pp.gs_planes(n), hcs, c, msm_mod.pinned_pads(n, c), msm_mod._beffs(c)
        )
    else:
        g = pp.gs_points(n)
        pts = cv.PointVec(*(a[:, None].expand(L, K, n) for a in g))
        comm, flag = msm_mod.msm_rows(pts, hcs), torch.ones((), dtype=torch.bool, device=pp.device)
    return cv.peq(comm, cv.from_affine_ints(Us, pp.device)) & flag


def check_many_device(checks, pp: pp_mod.PublicParams):
    """Full checks of K claims [(C, d, z, v, pi)] at one degree with the
    verdicts left on the device: (K,) bool, each the succinct row equation
    AND U == Commit(h) AND the pinned-pad flag.  Raises ValueError on
    host-checkable malformations (proof length)."""
    parts = [succinct_check_parts(*chk, pp) for chk in checks]
    ok_rows = _rows_and_isinf(*rows_tensors([(p[1], p[2]) for p in parts], pp.device))
    d = checks[0][1]
    return ok_rows & deferred_device([p[0] for p in parts], [chk[4].U for chk in checks], d, pp)


def check_device(C: Point, d: int, z: int, v: int, pi: EvalProof, pp: pp_mod.PublicParams):
    """Full check of one claim with the verdict left on the device."""
    return check_many_device([(C, d, z, v, pi)], pp)[0]


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
