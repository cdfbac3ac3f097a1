"""The port's profiling.py against the JAX package's: the staged and
grouped MSM cost models give the same counts (padds, fmuls) over a grid of
shapes, the throughput keys the same points rate; the port's rates are the
H100's (no TPU constant); trace writes <HALO_TPU_TRACE>/<label>.json."""

import json

import torch

from halo_accumulation_tpu import profiling as jprof
from halo_accumulation_tpu.ops import msm as jmsm
from halo_accumulation_tpu_torch import profiling as prof
from halo_accumulation_tpu_torch.ops import msm

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

SHARED = ("padds", "fmuls")


def test_msm_cost_matches_jax():
    for N in (1, 96, 16384, 1 << 20):
        for c in (3, 4, 8, 10, 12):
            for pad in (1, 2, 24, 384, 4096):
                for chunks in (1, 2, 32):
                    mine, theirs = prof.msm_cost(N, c, pad, chunks), jprof.msm_cost(N, c, pad, chunks)
                    assert set(mine) == set(theirs)
                    assert all(mine[k] == theirs[k] for k in SHARED)
                    assert mine["u32_gops"] == round(mine["fmuls"] * 88 / 1e9, 1)


def test_msm_cost_groups_matches_jax():
    for N in (128, 512, 16384, 65536, 1 << 20):
        for c in (4, 6, 8, 10, 12):
            pads, beffs = msm.pinned_pads(N, c), msm._beffs(c)
            assert (pads, beffs) == (jmsm.pinned_pads(N, c), jmsm._beffs(c))
            mine, theirs = prof.msm_cost_groups(N, c, pads, beffs), jprof.msm_cost_groups(N, c, pads, beffs)
            assert set(mine) == set(theirs) and all(mine[k] == theirs[k] for k in SHARED)


def test_throughput_keys_are_the_cards():
    """Same keys as the JAX package's but the utilisation, named for the
    card; the rate is the H100's 32-bit multiply rate."""
    mine = prof.msm_throughput(16384, 8, 384, 0.25)
    theirs = jprof.msm_throughput(16384, 8, 384, 0.25)
    assert set(mine) - set(theirs) == {"h100_int32_util_est"}
    assert set(theirs) - set(mine) == {"vpu_util_est"}
    assert mine["points_per_s"] == theirs["points_per_s"]
    assert mine["h100_int32_util_est"] == round(mine["achieved_u32_gops_per_s"] * 1e9 / (132 * 64 * 1.98e9), 3)
    pads, beffs = msm.pinned_pads(16384, 8), msm._beffs(8)
    mg = prof.msm_throughput_groups(16384, 8, pads, beffs, 0.1)
    tg = jprof.msm_throughput_groups(16384, 8, pads, beffs, 0.1)
    assert all(mg[k] == tg[k] for k in SHARED + ("points_per_s",))
    assert not any(hasattr(prof, k) for k in ("V5E_VPU_OPS_PER_S", "U32_OPS_PER_FMUL"))


def test_trace_writes_under_env(tmp_path, monkeypatch):
    monkeypatch.delenv("HALO_TPU_TRACE", raising=False)
    with prof.trace("off") as p:
        assert p is None
    monkeypatch.setenv("HALO_TPU_TRACE", str(tmp_path / "traces"))
    with prof.trace("msm_small"):
        torch.arange(1000).sum()
    path = tmp_path / "traces" / "msm_small.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert not (tmp_path / "traces" / "off.json").exists()
