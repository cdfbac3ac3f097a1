"""`correct` comes out false when the timed path is broken underneath: a
run on the CPU of the n = 16 cells (tests/small.py) with a fault planted
in the program, one request long, the request the fault meets; and with
the control (control.py) in the program's place.  The faults a cell can
have: the verifiers, part of the batch left out (either half, or all but
the last chunk of acc.KC claims) and an answer altered
where it is produced (no state carries from one request to the next); the
prover, a step that returns its state unchanged and an answer altered.
No exchange between chips exists on one chip."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import types

import pytest
import torch

from halo_accumulation_tpu_torch import acc as acc_mod
from portbench import control, generator, run
from portbench.tests import small

REPO = pathlib.Path(__file__).resolve().parents[2]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.copy(tmp_path_factory.mktemp("portbench"))


def _run(root, cell, key, plant=None, positions=None):
    seed = small.seed_with_first(root, cell, key, positions)
    res, _ = run.run(cell, seed, 0.1, False, root=root, device="cpu", plant=plant)
    assert res["attempted"] >= 1
    return res


def test_sound_runs_are_correct(root):
    assert _run(root, "decide-n16-k2", "cU")["correct"]
    assert _run(root, "decide-n16-k12", "L", positions={0})["correct"]
    assert _run(root, "verify-n16-k2", "valid")["correct"]


# a decide_many that decides part of its batch, and the positions of a
# tampered claim it leaves out, of the 12 in decide-n16-k12 (acc.KC = 10)
PARTS = {
    "the_first_half_left_out": (lambda accs: accs[len(accs) // 2 :], range(0, 6)),
    "the_second_half_left_out": (lambda accs: accs[: len(accs) // 2], range(6, 12)),
    "all_but_the_last_chunk_left_out": (lambda accs: accs[(len(accs) - 1) // acc_mod.KC * acc_mod.KC :], range(0, 10)),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_part_of_the_batch_left_out(root, monkeypatch, part):
    keep, missed = PARTS[part]
    real = acc_mod.decide_many
    monkeypatch.setattr(acc_mod, "decide_many", lambda accs, pp: real(keep(accs), pp))
    res = _run(root, "decide-n16-k12", "L", positions=set(missed))
    assert not res["correct"] and res["failed"] >= 1


def test_every_run_reaches_across_the_batch():
    """Each kind's tampered inputs of the decide cells fall in every quarter
    of the batch, whatever the seed, so a decider that leaves out any half
    or all but the last chunk meets one it cannot reject."""
    mix = json.loads((REPO / "portbench" / "traffic" / "decide-k100-tamper20.json").read_text())
    for seed in (0, 1, 2**31 + 5, 3 * 10**9 + 7):
        inputs = generator.stream(mix, seed, 100)[0].inputs
        for kind in mix["tamper_kinds"]:
            at = sorted(generator.parse_name(k)[1] // 25 for k in inputs if k.startswith(kind + "@"))
            assert at == [0, 1, 2, 3], (seed, kind, inputs)


def test_half_of_the_chain_left_out(root, monkeypatch):
    real = acc_mod.verify_chain
    monkeypatch.setattr(acc_mod, "verify_chain",
                        lambda d, qss, accs, pp: real(d, qss[: len(qss) // 2], accs[: len(accs) // 2], pp))
    assert not _run(root, "verify-n16-k2", "cU")["correct"]


@pytest.mark.parametrize("cell,name", [("decide-n16-k2", "decide_many"), ("verify-n16-k2", "verify_chain")])
def test_an_answer_altered_where_it_is_produced(root, monkeypatch, cell, name):
    real = getattr(acc_mod, name)

    def altered(*args):
        try:
            real(*args)
        except ValueError as e:
            raise ValueError(str(e).replace("index 0", "index 1")) from e
        raise ValueError("h(z) != v at step 0")

    monkeypatch.setattr(acc_mod, name, altered)
    assert not _run(root, cell, "L")["correct"]
    assert not _run(root, cell, "valid")["correct"]


@pytest.mark.parametrize("cell", ["decide-n16-k2", "verify-n16-k2"])
def test_the_control_is_not_correct(root, cell):
    res = _run(root, cell, "cU", plant=control.plant)
    # it differs on the cU requests, one in four, and agrees on the rest
    assert not res["correct"] and 1 <= res["failed"] < res["attempted"]


def _prover_fault(fault):
    """A plant: after set-up, acc.prover's result passed through fault(acc,
    the entry's last accumulator)."""
    def plant(entry):
        setup = entry.setup

        def setup_then_fault():
            setup()
            real = entry.acc.prover
            entry.acc = types.SimpleNamespace(prover=lambda *a: fault(real(*a), entry.prev))

        entry.setup = setup_then_fault
    return plant


def test_prover_sound_run_is_correct(root):
    assert _run(root, "prove-n16", "valid")["correct"]


def test_prover_step_returns_its_state_unchanged(root):
    assert not _run(root, "prove-n16", "valid", plant=_prover_fault(lambda acc, prev: prev))["correct"]


def test_prover_answer_altered_where_it_is_produced(root):
    altered = _prover_fault(lambda acc, prev: dataclasses.replace(acc, v=(acc.v + 1) % acc_mod.F.R))
    assert not _run(root, "prove-n16", "valid", plant=altered)["correct"]


def test_prover_control_is_not_correct(root):
    res = _run(root, "prove-n16", "valid", plant=control.plant)
    assert not res["correct"] and res["failed"] == res["attempted"]
