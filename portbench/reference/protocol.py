"""The plain reference of what the benchmark times: the PCS decider, the
batched deciders and the accumulated chain verifier, on plain Python ints.

It follows the upstream's protocol (rasmus-kirk/halo-accumulation:
pcdl.rs succinct_check and check, acc.rs verifier and decider) and the
order and texts in which the JAX package rejects a claim, and shares no
code with the program under test.

The URS is the upstream's hash-derived one: generator i is
gen(i) = Fr::from_le_bytes_mod_order(SHA3-256(GENESIS || i u64 LE)) * G,
S = gen(0), H = gen(1), G_j = gen(j + 2).  So a commitment sum_j a_j G_j is
(sum_j a_j gen(j + 2)) * G: the decider's n-point MSM is one dot product of
scalars and one scalar multiplication here, exactly.

Every check returns nothing on accept and raises Reject on reject; an
outcome is "accept" or "reject: <the JAX package's text>".
"""

from __future__ import annotations

import hashlib

from portbench.reference import curve
from portbench.reference.chainfile import Claim, point

R = curve.R
GENESIS = b"To understand recursion, one must first understand recursion"
ROW_TEXT = "C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})"
U_TEXT = "U != CM.Commit(ck, h_vec)"


class Reject(Exception):
    """A claim or chain the verifier rejects, with its text."""


def outcome(fn, *args) -> str:
    """"accept", "reject: <text>" or "error: <exception type>" for fn(*args)."""
    try:
        fn(*args)
    except Reject as e:
        return f"reject: {e}"
    except AssertionError:
        return "error: AssertionError"
    return "accept"


# -- serialization and the Fiat-Shamir oracles ---------------------------------


def ser_scalar(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def ser_u64(n: int) -> bytes:
    return n.to_bytes(8, "little")


def ser_scalars(xs) -> bytes:
    return ser_u64(len(xs)) + b"".join(ser_scalar(x) for x in xs)


def rho(tag: int, *parts: bytes) -> int:
    """SHA3-256 of the parts and the tag as u32 LE, read mod r."""
    h = hashlib.sha3_256()
    for p in parts:
        h.update(p)
    h.update(tag.to_bytes(4, "little"))
    return int.from_bytes(h.digest(), "little") % R


def gen_scalar(i: int) -> int:
    return int.from_bytes(hashlib.sha3_256(GENESIS + i.to_bytes(8, "little")).digest(), "little") % R


class Urs:
    """The discrete logs of the n-generator URS, and S and H as points."""

    def __init__(self, n: int):
        self.n = n
        self.logs = [gen_scalar(i) for i in range(n + 2)]
        self.S = curve.mul(self.logs[0], curve.G)
        self.H = curve.mul(self.logs[1], curve.G)

    def commit(self, coeffs) -> tuple | None:
        """sum_j coeffs[j] G_j."""
        if len(coeffs) > self.n:
            raise AssertionError
        return curve.mul(sum(a * g for a, g in zip(coeffs, self.logs[2:])), curve.G)

    def commit_h(self, xis) -> tuple | None:
        """sum_j h_j G_j for h(X) = prod_i (1 + xis[lg n - i] X^(2^i)): the
        generators' logs folded bit by bit, lowest bit first."""
        lg = len(xis) - 1
        v = self.logs[2 : 2 + (1 << lg)]
        for i in range(lg):
            x = xis[lg - i]
            v = [(a + x * b) % R for a, b in zip(v[0::2], v[1::2])]
        return curve.mul(v[0], curve.G)


def h_eval(xis, z: int) -> int:
    lg = len(xis) - 1
    v = (1 + xis[lg] * z) % R
    zi = z
    for i in range(1, lg):
        zi = zi * zi % R
        v = v * (1 + xis[lg - i] * zi) % R
    return v


# -- PCS: the succinct check and the decider -------------------------------------


def _scalar_inverses(xs):
    return [pow(x, -1, R) for x in xs]


class Reference:
    """The checks over one URS; each claim's succinct check is computed
    once and kept by the claim's bytes."""

    def __init__(self, urs: Urs):
        self.urs = urs
        self._succinct: dict = {}
        self._deferred: dict = {}

    def succinct(self, cl: Claim, raw: bytes) -> tuple[bool, list]:
        """(row holds, xis) of pcdl.rs succinct_check; raises Reject for the
        malformations the host finds first."""
        key = raw[cl.span[0] : cl.span[1]] if raw else None
        if key is not None and key in self._succinct:
            return self._succinct[key]
        res = self._succinct_uncached(cl)
        if key is not None:
            self._succinct[key] = res
        return res

    def _succinct_uncached(self, cl: Claim) -> tuple[bool, list]:
        n = cl.d + 1
        lg = n.bit_length() - 1
        if n & (n - 1):
            raise Reject("d+1 is not a power of 2")
        pi = cl.pi
        if len(pi.Ls) != lg or len(pi.Rs) != lg:
            raise Reject("proof length mismatch")
        C = point(cl.C)
        if pi.C_bar is not None:
            C_bar = point(pi.C_bar)
            a = rho(0, curve.compress(C), ser_scalar(cl.z), ser_scalar(cl.v), curve.compress(C_bar))
            C = curve.msm([1, a, -pi.w_prime], [C, C_bar, self.urs.S])
        xis = [rho(0, curve.compress(C), ser_scalar(cl.z), ser_scalar(cl.v))]
        for Lb, Rb in zip(pi.Ls, pi.Rs):
            xis.append(rho(0, ser_scalar(xis[-1]), curve.compress(point(Lb)), curve.compress(point(Rb))))
        v_prime = pi.c * h_eval(xis, cl.z) % R
        pts = [C, self.urs.H] + [point(b) for b in pi.Ls + pi.Rs] + [point(pi.U)]
        scs = [1, (cl.v - v_prime) * xis[0]] + _scalar_inverses(xis[1:]) + xis[1:] + [-pi.c]
        return curve.msm(scs, pts) is None, xis

    def deferred(self, cl: Claim, xis) -> bool:
        """U == CM.Commit(ck, h_vec): the decider's n-point MSM."""
        key = (cl.d, tuple(xis), cl.pi.U)
        if key not in self._deferred:
            self._deferred[key] = point(cl.pi.U) == self.urs.commit_h(xis)
        return self._deferred[key]

    def decider(self, cl: Claim, raw: bytes) -> None:
        """pcdl.rs check: the succinct check, then U against h's commitment."""
        ok, xis = self.succinct(cl, raw)
        if not ok:
            raise Reject(ROW_TEXT.format(b=0))
        if not self.deferred(cl, xis):
            raise Reject(U_TEXT)

    # -- the batched deciders (acc.decide_many) --------------------------------

    def decide_many(self, accs: list, raw: bytes) -> None:
        """A decider for every accumulator.  The host malformations of every
        claim come first, in order; then each claim's verdict in order."""
        parts = [self.succinct(a, raw) for a in accs]
        for a, (ok, xis) in zip(accs, parts):
            if not ok:
                raise Reject(ROW_TEXT.format(b=0))
            if not self.deferred(a, xis):
                raise Reject(U_TEXT)

    # -- the accumulation verifier ---------------------------------------------

    def combine(self, results, h0: list, U0: bytes, w: int):
        """(C_bar, z, h) of acc.rs common_subroutine from the checked
        instances' (xis, U) pairs; h evaluates h_0 + sum alpha^(i+1) h_i."""
        for_alpha = (b"\x01" + ser_scalars(h0) + ser_u64(len(results))
                     + b"".join(ser_scalars(xis) for xis, _ in results) + b"\x00" + ser_u64(0))
        alpha = rho(1, for_alpha)
        alphas = [pow(alpha, i, R) for i in range(len(results) + 1)]
        C = curve.msm(alphas, [point(U0)] + [point(U) for _, U in results])
        z = rho(1, curve.compress(C), ser_scalar(alpha))
        C_bar = curve.add(C, curve.mul(w, self.urs.S))

        def h(x: int) -> int:
            v = sum(c * pow(x, j, R) for j, c in enumerate(h0))
            return (v + sum(h_eval(xis, x) * alphas[i + 1] for i, (xis, _) in enumerate(results))) % R

        return C_bar, z, h

    def u0_holds(self, acc: Claim) -> bool:
        return point(acc.U0) == self.urs.commit(acc.h)

    def verify_chain(self, D: int, qss: list, accs: list, raw: bytes) -> None:
        """acc.verify_chain: a verifier at every step and one final decider,
        failing in the JAX package's order: the host malformations, then
        each step's host equalities, then the succinct rows in order, the
        U_0 rows, and the final decider."""
        if len(qss) != len(accs):
            raise AssertionError
        flat = [q for qs in qss for q in qs]
        parts = [self.succinct(q, raw) for q in flat]
        last = accs[-1]
        last_ok, last_xis = self.succinct(last, raw)
        if last.d + 1 > self.urs.n:
            raise AssertionError
        lo = 0
        for k, (qs, acc) in enumerate(zip(qss, accs)):
            for q in qs:
                if q.d != D:
                    raise Reject(f"d_i != d at step {k}")
            res = [(xis, q.pi.U) for q, (_, xis) in zip(qs, parts[lo : lo + len(qs)])]
            lo += len(qs)
            C_bar, z, h = self.combine(res, acc.h, acc.U0, acc.w)
            if C_bar != point(acc.C):
                raise Reject(f"C_bar' != C_bar at step {k}")
            if z != acc.z:
                raise Reject(f"z' != z at step {k}")
            if h(acc.z) != acc.v:
                raise Reject(f"h(z) != v at step {k}")
        for b, (ok, _) in enumerate(parts):
            if not ok:
                raise Reject(ROW_TEXT.format(b=b))
        for k, acc in enumerate(accs):
            if not self.u0_holds(acc):
                raise Reject(f"U_0 != PCDL.Commit(h_0) at step {k}")
        if not last_ok:
            raise Reject(ROW_TEXT.format(b=0))
        if not self.deferred(last, last_xis):
            raise Reject(U_TEXT)

    def verifier(self, D: int, qs: list, acc: Claim, raw: bytes) -> None:
        """acc.rs verifier (one step, not batched), then the decider of its
        accumulator: what a step of the prover has to pass."""
        if not self.u0_holds(acc):
            raise Reject("U_0 != PCDL.Commit(h_0)")
        for q in qs:
            if q.d != D:
                raise Reject("d_i != d")
        parts = [self.succinct(q, raw) for q in qs]
        for b, (ok, _) in enumerate(parts):
            if not ok:
                raise Reject(ROW_TEXT.format(b=b))
        C_bar, z, h = self.combine([(xis, q.pi.U) for q, (_, xis) in zip(qs, parts)], acc.h, acc.U0, acc.w)
        if C_bar != point(acc.C):
            raise Reject("C_bar' != C_bar")
        if z != acc.z:
            raise Reject("z' != z")
        if D != acc.d:
            raise Reject("d' != d")
        if h(acc.z) != acc.v:
            raise Reject("h(z) != v")
        self.decider(acc, raw)
