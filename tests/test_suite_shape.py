"""The shape of the test suite itself: only tests of the JAX reference may be
marked slow (tier-1 deselects them), and every test that spawns ranks joins
them through tests/_spawn.py, under a deadline."""

import ast
import pathlib
import time

import pytest
import torch.multiprocessing as mp

from tests._spawn import join_all

TESTS = pathlib.Path(__file__).resolve().parent


def _trees():
    return {p.name: ast.parse(p.read_text(), str(p)) for p in sorted(TESTS.glob("*.py"))}


def _imports(tree) -> set:
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def _tests_the_port(name: str, tree) -> bool:
    """Named test_torch_*.py, or importing the port or a port test module."""
    return name.startswith("test_torch_") or any(
        m.split(".")[0] == "halo_accumulation_tpu_torch" or m.startswith("tests.test_torch_") for m in _imports(tree))


def test_no_port_test_is_slow():
    """A slow mark takes a test out of tier-1; the port's tests stay in."""
    marked = [name for name, tree in _trees().items()
              if name.startswith("test_") and _tests_the_port(name, tree)
              and any(isinstance(n, ast.Attribute) and n.attr == "slow" and isinstance(n.value, ast.Attribute)
                      and n.value.attr == "mark" for n in ast.walk(tree))]
    assert marked == [], f"port test files marked slow: {marked}"


def test_spawned_ranks_join_through_helper():
    """Outside tests/_spawn.py, .join( is called only on a string or on
    os.path: a spawn context, a process or a thread is joined through
    join_all and its deadline."""
    calls = [f"{name}:{n.lineno}" for name, tree in _trees().items() if name != "_spawn.py"
             for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "join"
             and not isinstance(n.func.value, (ast.Constant, ast.JoinedStr))
             and not (isinstance(n.func.value, ast.Attribute) and n.func.value.attr == "path")]
    assert calls == [], f"joins outside tests/_spawn.py: {calls}"


def _sleep(rank: int) -> None:
    time.sleep(600)


def test_join_all_deadline_fails_and_terminates():
    ctx = mp.start_processes(_sleep, nprocs=1, join=False, start_method="spawn")
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"world 1 ranks \[0\]"):
        with join_all([ctx], 2):
            pass
    assert time.monotonic() - t0 < 30
    (p,) = ctx.processes
    assert not p.is_alive() and p.exitcode is not None, "the rank outlived its deadline"
