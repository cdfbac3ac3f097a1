"""parallel/dryrun.dryrun_multichip(2) on gloo: both ranks run the five
phases and rank 0 prints a timed line for each, every phase inside its
budget.

On the CPU the dry run's three provers (chain.random_instance, acc.prover
and chain.build_chain: about three minutes on two CPU ranks) hand out the
claims of tests/data/chain_16_2.bin instead, the JAX package's
build_chain(default_rng(7), 16, 2) written by tools/port_test_chain.py:
phase 2 checks that chain's last two instances, phase 4 verifies its last
accumulator and phase 5 verifies the chain.  The spawn, the budgets, the
sharded MSM, the mesh open and every check run as the command runs them.
The whole dry run, proving included, runs on the card in
tests/test_torch_cuda.py::test_dryrun_one_card."""

import pathlib
import re

import torch

from halo_accumulation_tpu_torch.parallel import dryrun
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

CHAIN = pathlib.Path(__file__).resolve().parent / "data" / "chain_16_2.bin"


def _rank_on_saved_claims(rank: int, world: int, store: str, device_type: str) -> None:
    """A spawned rank: dryrun._rank with the provers replaced by the saved
    chain's claims."""
    from halo_accumulation_tpu_torch import acc, chain

    d, qss, accs = chain.load_chain(CHAIN)
    instances = iter(qss[-1])

    def prover(rng, dd, qs, pp):
        assert (dd, qs) == (d, qss[-1])
        return accs[-1]

    chain.random_instance = lambda rng, dd, pp: next(instances)
    acc.prover = prover
    chain.build_chain = lambda rng, n, k, pp: (d, qss, accs)
    dryrun._rank(rank, world, store, device_type)


def test_dryrun_two_ranks(capfd, monkeypatch):
    monkeypatch.setattr(dryrun, "_rank", _rank_on_saved_claims)
    dryrun.dryrun_multichip(2)
    out = capfd.readouterr().out
    lines = re.findall(r"dryrun\[.*\] (\d)/5 .*: ([0-9.]+) s \(budget (\d+) s\)", out)
    assert [int(i) for i, _, _ in lines] == [1, 2, 3, 4, 5], out
    assert all(float(s) < float(b) for _, s, b in lines)
    assert "dryrun_multichip OK: 2 ranks, n = 16" in out
