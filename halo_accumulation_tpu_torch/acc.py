"""ASDL: the accumulation prover, verifier and decider, and the batched chain
verifiers.

Counterpart of `halo_accumulation_tpu/acc.py` (the reference's acc.rs
common_subroutine :135, prover :190, verifier :223, decider :245), with the
same Fiat-Shamir quirks:

  * alpha = rho_1(AccumulatedHPolys) hashes the struct with alpha = None and
    alphas = [] (both serialized: a 0x00 option tag and an empty vec);
  * z = rho_1(C, alpha) hashes alpha itself.

`verify_chain` and `decide_many` enqueue every device verdict first, do the
per-step host bookkeeping, and then copy all verdicts to the host once; the
checks run, and fail, in the same order and with the same ValueError texts
as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import hostops as H
from halo_accumulation_tpu_torch import pcdl
from halo_accumulation_tpu_torch import pp as pp_mod
from halo_accumulation_tpu_torch.ops import msm as msm_mod, poly as poly_mod
from halo_accumulation_tpu_torch.ops.field import FR
from halo_accumulation_tpu_torch.utils import serialize as ser
from halo_accumulation_tpu_torch.utils import transcript as tr


@dataclass
class Instance:
    """q: a claim that the polynomial committed in C has p(z) = v."""

    C: pcdl.Point
    d: int
    z: int
    v: int
    pi: pcdl.EvalProof

    def serialize(self) -> bytes:
        return (
            ser.ser_point(self.C)
            + ser.ser_u64(self.d)
            + ser.ser_scalar(self.z)
            + ser.ser_scalar(self.v)
            + self.pi.serialize()
        )


@dataclass
class AccumulatorHiding:
    """pi_V = (h_0, U_0, omega)."""

    h: list  # degree-1 polynomial coefficients [b, a]
    U: pcdl.Point
    w: int


@dataclass
class Accumulator:
    """acc = ((C_bar, d, z, v), pi) + pi_V."""

    C_bar: pcdl.Point
    d: int
    z: int
    v: int
    pi: pcdl.EvalProof
    pi_V: AccumulatorHiding

    def to_instance(self) -> Instance:
        return Instance(self.C_bar, self.d, self.z, self.v, self.pi)


class AccumulatedHPolys:
    """h_0 + sum alpha^(i+1) h_i bookkeeping."""

    def __init__(self, m: int):
        self.h_0: list | None = None
        self.hs: list[pcdl.HPoly] = []
        self.alpha: int | None = None
        self.alphas: list[int] = []
        self._cap = m + 1

    def set_alpha(self, alpha: int):
        self.alpha = alpha
        a, cur = [], 1
        for _ in range(self._cap):
            a.append(cur)
            cur = cur * alpha % F.R
        self.alphas = a

    def serialize_for_alpha(self) -> bytes:
        """The struct as hashed for alpha: alpha = None, alphas = []."""
        out = ser.ser_option(ser.ser_poly(self.h_0) if self.h_0 is not None else None)
        out += ser.ser_vec([h.serialize() for h in self.hs])
        out += ser.ser_option(None)
        out += ser.ser_vec([])
        return out

    def eval(self, z: int) -> int:
        v = 0
        if self.h_0 is not None:
            zp = 1
            for c in self.h_0:
                v = (v + c * zp) % F.R
                zp = zp * z % F.R
        for i, h in enumerate(self.hs):
            v = (v + h.eval(z) * self.alphas[i + 1]) % F.R
        return v

    def coeffs_device(self, n: int, device):
        """Dense coefficients (18, n) of h_0 + sum alpha^(i+1) h_i."""
        acc = FR.from_ints(self.h_0 if self.h_0 is not None else [0], device)
        if acc.shape[1] < n:
            acc = torch.cat([acc, FR.zeros((n - acc.shape[1],), device)], dim=1)
        for i, h in enumerate(self.hs):
            hc = poly_mod.tensor_h_coeffs(FR.from_ints(h.xis, device))
            acc = poly_mod.add(acc, poly_mod.scale(hc, FR.from_ints([self.alphas[i + 1]], device)[:, 0]))
        return acc


def _combine(qs_results, pi_V: AccumulatorHiding, pp: pp_mod.PublicParams):
    """Shared tail of common_subroutine: alpha, C, z and C_bar from the
    checked instances' (HPoly, U) pairs."""
    hs = AccumulatedHPolys(len(qs_results))
    hs.h_0 = list(pi_V.h)
    Us = [pi_V.U]
    for h_i, U_i in qs_results:
        hs.hs.append(h_i)
        Us.append(U_i)
    hs.set_alpha(tr.rho_1(hs.serialize_for_alpha()))
    C = pcdl.host_msm(hs.alphas[: len(Us)], Us)
    z = tr.rho_1(ser.ser_point(C), ser.ser_scalar(hs.alpha))
    C_bar = H.p_add(C, H.p_mul(pi_V.w, pp.s))
    return C_bar, z, hs


def common_subroutine(d: int, qs: list[Instance], pi_V: AccumulatorHiding, pp: pp_mod.PublicParams):
    """T^rho(avk, qs, pi_V): (C_bar, d, z, AccumulatedHPolys)."""
    if pcdl.commit(list(pi_V.h), d, None, pp) != pi_V.U:
        raise ValueError("U_0 != PCDL.Commit(h_0)")
    for q in qs:
        if q.d != d:
            raise ValueError("d_i != d")
    results = pcdl.succinct_check_batch([(q.C, q.d, q.z, q.v, q.pi) for q in qs], pp)
    C_bar, z, hs = _combine(results, pi_V, pp)
    return C_bar, d, z, hs


def prover(rng, d: int, qs: list[Instance], pp: pp_mod.PublicParams) -> Accumulator:
    """Accumulation prover (acc.rs:190-220).  rng: a numpy Generator, drawn
    from as the JAX prover draws (h_0's two coefficients, w, then open_'s
    hiding draws), so the same rng gives the same accumulator bytes."""
    h_0 = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2)]
    U_0 = pcdl.commit(h_0, d, None, pp)
    w = int.from_bytes(rng.bytes(40), "little") % F.R
    pi_V = AccumulatorHiding(h=h_0, U=U_0, w=w)
    C_bar, d, z, hs = common_subroutine(d, qs, pi_V, pp)
    v = hs.eval(z)
    pi = pcdl.open_(rng, hs.coeffs_device(d + 1, pp.device), C_bar, d, z, w, pp, v=v)
    return Accumulator(C_bar=C_bar, d=d, z=z, v=v, pi=pi, pi_V=pi_V)


def verifier(D: int, qs: list[Instance], acc: Accumulator, pp: pp_mod.PublicParams):
    """Accumulation verifier.  Raises ValueError on reject."""
    C_bar_p, d_p, z_p, hs = common_subroutine(D, qs, acc.pi_V, pp)
    if C_bar_p != acc.C_bar:
        raise ValueError("C_bar' != C_bar")
    if z_p != acc.z:
        raise ValueError("z' != z")
    if d_p != acc.d:
        raise ValueError("d' != d")
    if hs.eval(acc.z) != acc.v:
        raise ValueError("h(z) != v")


def decider(acc: Accumulator, pp: pp_mod.PublicParams):
    """Decider: one full PCDL check of the accumulator."""
    pcdl.check(acc.C_bar, acc.d, acc.z, acc.v, acc.pi, pp)


# claims a decide_many chunk batches: one row MSM and one K-fold deferred MSM
# (one CUDA graph keyed (B, M, K, n)) for at most this many
KC = 10


def decide_many(accs: list[Accumulator], pp: pp_mod.PublicParams):
    """The decider for every accumulator: the full checks batched on the
    device in chunks of at most KC claims (each chunk one row MSM and one
    K-fold deferred MSM; a full chunk replays one graph), the verdicts
    joined on the device and copied to the host once; a False verdict
    re-checks that step through the measured-pad path, which raises the
    decider's precise error.  The chunks bound the deferred MSMs' memory:
    the JAX package runs one claim at a time."""
    if not accs:
        return
    if any(a.d != accs[0].d for a in accs):
        oks = torch.stack([pcdl.check_device(a.C_bar, a.d, a.z, a.v, a.pi, pp) for a in accs])
    else:
        claims = [(a.C_bar, a.d, a.z, a.v, a.pi) for a in accs]
        chunks = [pcdl.check_many_device(claims[i : i + KC], pp) for i in range(0, len(claims), KC)]
        oks = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    for a, ok in zip(accs, oks.cpu().tolist()):
        if not ok:
            pcdl.recheck(a.C_bar, a.d, a.z, a.v, a.pi, pp)


def verify_chain(D: int, qss: list[list[Instance]], accs: list[Accumulator], pp: pp_mod.PublicParams,
                 mesh=None, axis: str | None = None):
    """The verifier at every chain step plus one final decider (the
    reference's fast-path helper), batched:

      * every row equation - each step's succinct checks, each step's
        U_0 == Commit(h_0) (3 points a row) and the final decider's
        succinct check - runs as ONE batched row MSM,
      * the final decider's deferred n-point MSM and U equality follow;
        under sortrows with at most 32 succinct checks and 32 steps, all
        of it is one CUDA graph on the card (pcdl.verdicts_device),
      * per-step challenges and equalities run on the host meanwhile,
      * one copy brings every device verdict back.

    mesh: a 1-D DeviceMesh (parallel/msm_sharded.make_mesh): the JAX
    package's non-fused path, no graph: the succinct rows and the U_0 rows
    split over its ranks (pcdl.rows_sharded), and the final decider through
    pcdl.check_device(mesh=), which splits its deferred MSM when the mesh's
    size divides n and else runs the single-device check.  Every rank must call it with the same arguments; each
    gets the same verdicts and raises the same error.

    Raises ValueError on any rejection, and AssertionError (as the JAX
    package does) when qss and accs differ in length."""
    if len(qss) != len(accs):
        raise AssertionError
    last = accs[-1]
    flat, step_slices = [], []
    for qs in qss:
        step_slices.append((len(flat), len(flat) + len(qs)))
        flat.extend((q.C, q.d, q.z, q.v, q.pi) for q in qs)

    # ---- 1. enqueue all device work --------------------------------------
    g0, g1 = pp.gs_host(2)
    u0_rows = [([g0, g1, a.pi_V.U], [a.pi_V.h[0], a.pi_V.h[1], F.R - 1]) for a in accs]
    if mesh is None:
        parts = [pcdl.succinct_check_parts(C, d, z, v, pi, pp) for (C, d, z, v, pi) in flat]
        dh, dpts, dscs = pcdl.succinct_check_parts(last.C_bar, last.d, last.z, last.v, last.pi, pp)
        rows = [(p[1], p[2]) for p in parts] + u0_rows + [(dpts, dscs)]
        # one CUDA graph under the JAX package's condition for its one-program
        # verdict (_verify_chain_fused); eager otherwise
        fused = msm_mod._impl() == "sortrows" and len(flat) <= 32 and len(accs) <= 32
        ok_dev = pcdl.verdicts_device(rows, [dh], [last.pi.U], last.d, pp, graph=fused)
    else:
        parts, ok_succ = pcdl.succinct_check_batch_device(flat, pp, mesh, axis)
        ok_u0 = pcdl.rows_sharded(u0_rows, pp, mesh, axis, pow2=False)
        ok_dec = pcdl.check_device(last.C_bar, last.d, last.z, last.v, last.pi, pp, mesh=mesh, axis=axis)
        ok_dev = torch.cat([ok_succ[: len(flat)], ok_u0[: len(accs)], ok_dec.reshape(1)])

    # ---- 2. per-step host bookkeeping --------------------------------------
    results = [(p[0], flat[b][4].U) for b, p in enumerate(parts)]
    for k, (qs, acc) in enumerate(zip(qss, accs)):
        lo, hi = step_slices[k]
        for q in qs:
            if q.d != D:
                raise ValueError(f"d_i != d at step {k}")
        C_bar, z, hs = _combine(results[lo:hi], acc.pi_V, pp)
        if C_bar != acc.C_bar:
            raise ValueError(f"C_bar' != C_bar at step {k}")
        if z != acc.z:
            raise ValueError(f"z' != z at step {k}")
        if hs.eval(acc.z) != acc.v:
            raise ValueError(f"h(z) != v at step {k}")

    # ---- 3. one copy of every device verdict -------------------------------
    combined = ok_dev.cpu().tolist()
    nS = len(flat)
    for b in range(nS):
        if not combined[b]:
            raise ValueError(f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})")
    for b in range(len(accs)):
        if not combined[nS + b]:
            raise ValueError(f"U_0 != PCDL.Commit(h_0) at step {b}")
    if not combined[-1]:
        # the final decider: rule out a pinned-pad overflow before rejecting
        pcdl.recheck(last.C_bar, last.d, last.z, last.v, last.pi, pp)


def serialize_accumulator(acc: Accumulator) -> bytes:
    out = ser.ser_point(acc.C_bar)
    out += ser.ser_u64(acc.d)
    out += ser.ser_scalar(acc.z)
    out += ser.ser_scalar(acc.v)
    out += acc.pi.serialize()
    out += ser.ser_scalar_vec(acc.pi_V.h)
    out += ser.ser_point(acc.pi_V.U)
    out += ser.ser_scalar(acc.pi_V.w)
    return out


def deserialize_accumulator(b: bytes) -> Accumulator:
    off = 0

    def take(n):
        nonlocal off
        chunk = b[off : off + n]
        off += n
        return chunk

    C_bar = ser.deser_point(take(ser.POINT_BYTES))
    d = int.from_bytes(take(8), "little")
    z = int.from_bytes(take(32), "little")
    v = int.from_bytes(take(32), "little")
    pi, used = _parse_evalproof(b[off:])
    off += used
    nh = int.from_bytes(take(8), "little")
    h = [int.from_bytes(take(32), "little") for _ in range(nh)]
    U = ser.deser_point(take(ser.POINT_BYTES))
    w = int.from_bytes(take(32), "little")
    return Accumulator(C_bar, d, z, v, pi, AccumulatorHiding(h, U, w))


def _parse_evalproof(b: bytes):
    """(EvalProof, bytes used) from the front of b."""
    return pcdl.EvalProof.parse(b)
