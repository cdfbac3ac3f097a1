"""Accumulation chains: loading and the two batch verification paths.

Counterpart of the verifier half of `halo_accumulation_tpu/chain.py`.  A
chain is K steps; step 0 accumulates [q_0] and step i accumulates
[acc_{i-1} as an instance, q_i].  The reference benchmarks two ways to
check one: the fast path (a verifier per step + one final decider) and the
slow path (a decider per step).
"""

from __future__ import annotations

import pathlib

from halo_accumulation_tpu_torch import acc as acc_mod
from halo_accumulation_tpu_torch import pp as pp_mod
from halo_accumulation_tpu_torch.utils import serialize as ser

CHAIN_MAGIC = b"HALOCHN2"


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
