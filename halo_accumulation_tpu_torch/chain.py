"""Accumulation chains: building, saving, loading and the two batch
verification paths.

Counterpart of `halo_accumulation_tpu/chain.py` (the reference's
benches/acc.rs).  A chain is K steps; step 0 accumulates [q_0] and step i
accumulates [acc_{i-1} as an instance, q_i], each q a random hiding
instance.  The reference benchmarks two ways to check one: the fast path
(a verifier per step + one final decider) and the slow path (a decider per
step).  Given the same numpy rng the builder draws exactly what the JAX
builder draws, so it writes the same bytes.
"""

from __future__ import annotations

import pathlib

from halo_accumulation_tpu_torch import acc as acc_mod
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch import pcdl
from halo_accumulation_tpu_torch import pp as pp_mod
from halo_accumulation_tpu_torch.ops.field import FR
from halo_accumulation_tpu_torch.utils import serialize as ser

CHAIN_MAGIC = b"HALOCHN2"


def rand_scalar(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % F.R


def random_instance(rng, d: int, pp: pp_mod.PublicParams) -> acc_mod.Instance:
    """A random hiding instance (benches/acc.rs:15-29): commit to a random
    polynomial of degree d' ~ U[d/2, d) with hiding, evaluate it at a random
    z, open."""
    d_prime = int(rng.integers(d // 2, d))
    w = rand_scalar(rng)
    coeffs = [rand_scalar(rng) for _ in range(d_prime + 1)]
    z = rand_scalar(rng)
    v, zp = 0, 1
    for co in coeffs:
        v = (v + co * zp) % F.R
        zp = zp * z % F.R
    cd = FR.from_ints(coeffs, pp.device)
    C = pcdl.commit(cd, d, w, pp)
    pi = pcdl.open_(rng, cd, C, d, z, w, pp, v=v)
    return acc_mod.Instance(C=C, d=d, z=z, v=v, pi=pi)


def build_chain(rng, n: int, k: int, pp: pp_mod.PublicParams):
    """k-step accumulation chain at d = n - 1 (benches/acc.rs:76-98):
    (d, qss, accs)."""
    d = n - 1
    qss, accs = [], []
    prev = None
    for _ in range(k):
        q = random_instance(rng, d, pp)
        qs = [prev.to_instance(), q] if prev is not None else [q]
        prev = acc_mod.prover(rng, d, qs, pp)
        qss.append(qs)
        accs.append(prev)
    return d, qss, accs


def step_records(qss, accs) -> list[bytes]:
    """Each step's bytes as a chain file holds them: len(qs) u64, the
    instances, len(acc) u64, the accumulator."""
    out = []
    for qs, acc in zip(qss, accs):
        ab = acc_mod.serialize_accumulator(acc)
        out.append(b"".join([len(qs).to_bytes(8, "little"), *(q.serialize() for q in qs),
                             len(ab).to_bytes(8, "little"), ab]))
    return out


def save_chain(path, d: int, qss, accs) -> None:
    """Write a chain in the tagged layout: magic || d u64 || k u64 || steps."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    head = [CHAIN_MAGIC, d.to_bytes(8, "little"), len(accs).to_bytes(8, "little")]
    p.write_bytes(b"".join(head + step_records(qss, accs)))


def deserialize_instance(b: bytes):
    """One serialized Instance from the front of b: (Instance, bytes used)."""
    off = 0
    C = ser.deser_point(b[off : off + ser.POINT_BYTES])
    off += ser.POINT_BYTES
    d = int.from_bytes(b[off : off + 8], "little")
    off += 8
    z = int.from_bytes(b[off : off + 32], "little")
    off += 32
    v = int.from_bytes(b[off : off + 32], "little")
    off += 32
    pi, used = acc_mod._parse_evalproof(b[off:])
    return acc_mod.Instance(C=C, d=d, z=z, v=v, pi=pi), off + used


def load_chain(path):
    """(d, qss, accs) from a chain file.  Two layouts exist: the tagged one
    (magic || d u64 || k u64 || steps) and the older untagged one that starts
    with d; d < 2^56 can never begin with the magic's 'H' byte."""
    b = pathlib.Path(path).read_bytes()
    off = 8 if b[:8] == CHAIN_MAGIC else 0
    d = int.from_bytes(b[off : off + 8], "little")
    off += 8
    k = int.from_bytes(b[off : off + 8], "little")
    off += 8
    qss, accs = [], []
    for _ in range(k):
        m = int.from_bytes(b[off : off + 8], "little")
        off += 8
        qs = []
        for _ in range(m):
            q, used = deserialize_instance(b[off:])
            off += used
            qs.append(q)
        alen = int.from_bytes(b[off : off + 8], "little")
        off += 8
        accs.append(acc_mod.deserialize_accumulator(b[off : off + alen]))
        off += alen
        qss.append(qs)
    return d, qss, accs


def verify_chain_fast(d: int, qss, accs, pp: pp_mod.PublicParams) -> None:
    """Verifier at every step + one final decider.  Raises ValueError."""
    acc_mod.verify_chain(d, qss, accs, pp)


def verify_chain_slow(accs, pp: pp_mod.PublicParams) -> None:
    """A full decider at every step.  Raises ValueError."""
    acc_mod.decide_many(accs, pp)
