"""The plain reference on the CPU: it accepts the committed chains, rejects
tampered copies with the JAX package's texts in its order, and reads the
JAX package's bytes back exactly."""

from __future__ import annotations

import pathlib
import random

import pytest

from portbench import tamper
from portbench.reference import chainfile, curve, protocol

DATA = pathlib.Path(__file__).resolve().parents[1] / "data"
ROW = protocol.ROW_TEXT
# what each tamper kind of the last accumulator must give (tamper.py):
# verify_chain's host check catches v first; decide_many's succinct row
# catches it; only the decider's MSM catches cU
EXPECT = {
    "v": ("reject: h(z) != v at step {k}", "reject: " + ROW.format(b=0)),
    "L": ("reject: " + ROW.format(b=0),) * 2,
    "R": ("reject: " + ROW.format(b=0),) * 2,
    "U": ("reject: " + ROW.format(b=0),) * 2,
    "cU": ("reject: " + protocol.U_TEXT,) * 2,
}


@pytest.fixture(scope="module", params=[("chain_16_2.bin", 16), ("chain_512_10.bin", 512)], ids=["n16", "n512"])
def chain(request):
    name, n = request.param
    return chainfile.read(DATA / name), protocol.Urs(n)


def test_accepts_the_committed_chains(chain):
    ch, urs = chain
    ref = protocol.Reference(urs)
    assert protocol.outcome(ref.verify_chain, ch.d, ch.qss, ch.accs, ch.raw) == "accept"
    assert protocol.outcome(ref.decide_many, ch.accs, ch.raw) == "accept"


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_rejects_each_tamper_kind_with_the_jax_text(chain, kind):
    ch, urs = chain
    raw = tamper.tamper(ch, kind, random.Random(11), urs)
    assert raw != ch.raw
    t = chainfile.parse(raw)
    ref = protocol.Reference(urs)
    want_verify, want_decide = EXPECT[kind]
    assert protocol.outcome(ref.verify_chain, t.d, t.qss, t.accs, raw) == want_verify.format(k=len(t.accs) - 1)
    assert protocol.outcome(ref.decide_many, t.accs, raw) == want_decide


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_decide_many_rejects_a_tamper_at_any_step(chain, kind):
    """decide_many's text for a claim tampered at step 0 is the one for
    the last step: its texts name no claim."""
    ch, urs = chain
    t = chainfile.parse(tamper.tamper(ch, kind, random.Random(12), urs, 0))
    assert t.accs[1:] == ch.accs[1:] and t.accs[0] != ch.accs[0]
    assert protocol.outcome(protocol.Reference(urs).decide_many, t.accs, t.raw) == EXPECT[kind][1]


def _with(ch, at, data: bytes) -> chainfile.Chain:
    raw = bytearray(ch.raw)
    raw[at[0] : at[0] + at[1]] = data
    return chainfile.parse(bytes(raw))


def test_rejects_earlier_steps_in_the_jax_order(chain):
    """A tampered instance or accumulator of an earlier step: verify_chain
    raises that step's host check before any succinct row."""
    ch, urs = chain
    ref = protocol.Reference(urs)
    q = ch.qss[1][-1]  # step 1's fresh instance
    t = _with(ch, q.at["v"], protocol.ser_scalar(q.v + 1))
    # its v changes its challenges, so alpha, C and C_bar at step 1
    assert protocol.outcome(ref.verify_chain, t.d, t.qss, t.accs, t.raw) == "reject: C_bar' != C_bar at step 1"
    a = ch.accs[0]
    t = _with(ch, a.at["C"], curve.compress(curve.neg(chainfile.point(a.C))))
    assert protocol.outcome(ref.verify_chain, t.d, t.qss, t.accs, t.raw) == "reject: C_bar' != C_bar at step 0"
    t = _with(ch, a.at["z"], protocol.ser_scalar(a.z + 1))
    assert protocol.outcome(ref.verify_chain, t.d, t.qss, t.accs, t.raw) == "reject: z' != z at step 0"
    t = _with(ch, a.at["U0"], curve.compress(curve.neg(chainfile.point(a.U0))))
    assert protocol.outcome(ref.verify_chain, t.d, t.qss, t.accs, t.raw) == "reject: C_bar' != C_bar at step 0"
    assert protocol.outcome(ref.decide_many, t.accs, t.raw) == "accept"  # U_0 is not the decider's


def _ser_claim(cl) -> bytes:
    """A claim written back from the parsed values (points re-compressed
    from their decompressed coordinates)."""
    pt = lambda b: curve.compress(chainfile.point(b))  # noqa: E731
    sc = protocol.ser_scalar
    pi = cl.pi
    out = pt(cl.C) + protocol.ser_u64(cl.d) + sc(cl.z) + sc(cl.v)
    out += protocol.ser_u64(len(pi.Ls)) + b"".join(map(pt, pi.Ls)) + protocol.ser_u64(len(pi.Rs)) + b"".join(map(pt, pi.Rs))
    out += pt(pi.U) + sc(pi.c)
    out += b"\x00" if pi.C_bar is None else b"\x01" + pt(pi.C_bar)
    out += b"\x00" if pi.w_prime is None else b"\x01" + sc(pi.w_prime)
    if cl.h is not None:
        out += protocol.ser_scalars(cl.h) + pt(cl.U0) + sc(cl.w)
    return out


def test_reads_the_jax_packages_bytes_exactly():
    """The n = 16 chain the JAX package wrote, written back from what the
    reference parsed, is the same bytes: every point decompresses onto the
    curve and compresses back, every scalar is canonical."""
    ch = chainfile.read(DATA / "chain_16_2.bin")
    assert (ch.d, len(ch.qss), len(ch.accs)) == (15, 2, 2)
    out = chainfile.MAGIC + protocol.ser_u64(ch.d) + protocol.ser_u64(len(ch.accs))
    for qs, acc in zip(ch.qss, ch.accs):
        a = _ser_claim(acc)
        out += protocol.ser_u64(len(qs)) + b"".join(_ser_claim(q) for q in qs) + protocol.ser_u64(len(a)) + a
    assert out == ch.raw
    for cl in [q for qs in ch.qss for q in qs] + ch.accs:
        assert curve.on_curve(chainfile.point(cl.C)) and curve.on_curve(chainfile.point(cl.pi.U))


def test_curve_arithmetic_against_the_group_law():
    G = curve.G
    assert curve.on_curve(G)
    assert curve.mul(curve.R, G) is None and curve.mul(curve.R - 1, G) == curve.neg(G)
    a, b = 123456789, 987654321
    assert curve.add(curve.mul(a, G), curve.mul(b, G)) == curve.mul(a + b, G)
    assert curve.msm([a, b, 5], [G, curve.mul(7, G), None]) == curve.mul(a + 7 * b, G)
    assert curve.add(G, curve.neg(G)) is None and curve.add(G, G) == curve.mul(2, G)
    assert curve.decompress(curve.compress(curve.mul(a, G))) == curve.mul(a, G)
    assert curve.sqrt(5) is None or curve.sqrt(5) ** 2 % curve.Q == 5
