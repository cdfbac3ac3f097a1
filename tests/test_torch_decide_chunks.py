"""acc.decide_many in chunks of at most acc.KC = 10 claims: 12 claims (the
two accumulators of tests/data/chain_16_2.bin repeated, the JAX
package's build_chain(default_rng(7), 16, 2) written by
tools/port_test_chain.py) go through check_many_device twice, 10 claims
then 2, and give the verdicts check_device gives each claim alone; with
one claim's v off by one, the chunk's verdict for it is False and
decide_many raises the decider's text, as the per-claim check does."""

import dataclasses
import pathlib

import pytest
import torch

from halo_accumulation_tpu_torch import acc, chain, fields as F, pcdl, pp as pp_mod
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

CHAIN = pathlib.Path(__file__).resolve().parent / "data" / "chain_16_2.bin"
BAD = 11


def test_decide_many_chunks(monkeypatch):
    d, _, accs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(d + 1, "cpu")
    bumped = dataclasses.replace(accs[1], v=(accs[1].v + 1) % F.R)
    claims = (accs * 6)[:BAD] + [bumped]
    assert acc.KC == 10
    single = {id(a): bool(pcdl.check_device(a.C_bar, a.d, a.z, a.v, a.pi, pp)) for a in (*accs, bumped)}
    assert list(single.values()) == [True, True, False]
    calls = []
    real = pcdl.check_many_device

    def spy(checks, p):
        out = real(checks, p)
        calls.append((len(checks), out.tolist()))
        return out

    monkeypatch.setattr(pcdl, "check_many_device", spy)
    with pytest.raises(ValueError) as e:
        acc.decide_many(claims, pp)
    assert [k for k, _ in calls] == [10, 2]
    assert [v for _, vs in calls for v in vs] == [single[id(a)] for a in claims]
    with pytest.raises(ValueError) as e1:
        pcdl.check(bumped.C_bar, bumped.d, bumped.z, bumped.v, bumped.pi, pp)
    assert str(e.value) == str(e1.value) == "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"
