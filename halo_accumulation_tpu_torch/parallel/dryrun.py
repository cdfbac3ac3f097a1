"""Multi-device dry run: every parallel path of the port on tiny shapes.

    python3 -m halo_accumulation_tpu_torch.parallel.dryrun [N_DEVICES]

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.
`dryrun_multichip(n_devices)` spawns n_devices ranks joined by a
torch.distributed FileStore in a temporary directory (no network): NCCL, a
card a rank, when that many cards exist, else gloo on the CPU.  Every rank
runs the same five phases on a 1-D mesh (msm_sharded.make_mesh) with the
same numpy rng, so every rank computes the same values:

  1. msm_sharded over 8 points a rank against the single-device msm;
  2. succinct_check_batch(mesh=) on two random hiding instances, repeated
     n_devices times (rows split over the ranks);
  3. open_(mesh=) (the fold's width split over the ranks) on a fresh
     polynomial, then succinct_check of its proof;
  4. acc.prover on the two instances and acc.verifier of the accumulator;
  5. verify_chain(mesh=) on a 2-step chain built with build_chain.

The phases' width is n = d + 1 = WIDTH = 16 (the JAX dry run's d = 15);
the URS holds max(n, 8 n_devices) generators.  Rank 0 prints one timed
line per phase.  Each phase has its own budget (PHASE_BUDGET_S, sized for gloo
ranks on the CPU, where an n = 16 open takes about 15 s a rank); a rank
whose phase overruns it raises, and the parent ends the ranks and raises
once the sum of the budgets has passed.  Any failure raises: the command
exits non-zero.  Nothing is caught.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PHASES = ("msm_sharded", "succinct_check_batch", "open_ + succinct_check", "acc.prover + acc.verifier",
          "verify_chain")
PHASE_BUDGET_S = (120.0, 240.0, 180.0, 240.0, 360.0)  # seconds a phase may take on any rank
START_BUDGET_S = 180.0  # spawn, imports, process group and URS
WIDTH = 16  # n = d + 1, the JAX dry run's d = 15


def _phases(rank: int, world: int, mesh, dev) -> None:
    from halo_accumulation_tpu_torch import acc as acc_mod, chain, fields as F, pcdl
    from halo_accumulation_tpu_torch import pp as pp_mod
    from halo_accumulation_tpu_torch.ops import curve as cv, msm as msm_mod
    from halo_accumulation_tpu_torch.ops.field import FR
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    t0 = time.perf_counter()
    n, N = WIDTH, 8 * world
    pp = pp_mod.get_pp(max(n, 1 << (N - 1).bit_length()), dev)
    d = n - 1
    rng = np.random.default_rng(3)

    def tick(i: int, what: str, t: float) -> None:
        s = time.perf_counter() - t
        if s > PHASE_BUDGET_S[i - 1]:
            raise TimeoutError(f"dryrun phase {i}/5 ({PHASES[i - 1]}) took {s:.1f} s on rank {rank}, "
                               f"budget {PHASE_BUDGET_S[i - 1]:.0f} s")
        if rank == 0:
            print(f"dryrun[{time.perf_counter() - t0:7.1f} s] {i}/5 {what}: {s:.2f} s "
                  f"(budget {PHASE_BUDGET_S[i - 1]:.0f} s)", flush=True)

    t = time.perf_counter()
    scalars = FR.from_ints([chain.rand_scalar(rng) for _ in range(N)], dev)
    points = pp.gs_points(N)
    got = sh.msm_sharded(sh.shard_points(points, mesh), scalars, mesh)
    if not bool(cv.peq(got, msm_mod.msm(points, scalars))):
        raise AssertionError("msm_sharded != msm")
    tick(1, f"msm_sharded over {world} ranks at N = {N} equals msm", t)

    t = time.perf_counter()
    qs = [chain.random_instance(rng, d, pp) for _ in range(2)]
    checks = [(q.C, q.d, q.z, q.v, q.pi) for q in qs] * world
    if len(pcdl.succinct_check_batch(checks, pp, mesh=mesh, axis=sh.AXIS)) != len(checks):
        raise AssertionError("succinct_check_batch(mesh=) lost rows")
    tick(2, f"succinct_check_batch(mesh=) accepts {len(checks)} rows over {world} ranks", t)

    t = time.perf_counter()
    coeffs = [chain.rand_scalar(rng) for _ in range(n)]
    z = chain.rand_scalar(rng)
    C = pcdl.commit(FR.from_ints(coeffs, dev), d, None, pp)
    pi = pcdl.open_(rng, FR.from_ints(coeffs, dev), C, d, z, None, pp, mesh=mesh, axis=sh.AXIS)
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R
    pcdl.succinct_check(C, d, z, v, pi, pp)
    tick(3, f"open_(mesh=) at n = {n} passes succinct_check", t)

    t = time.perf_counter()
    acc_mod.verifier(d, qs, acc_mod.prover(rng, d, qs, pp), pp)
    tick(4, "acc.prover + acc.verifier", t)

    t = time.perf_counter()
    D, qss, accs = chain.build_chain(rng, n, 2, pp)
    acc_mod.verify_chain(D, qss, accs, pp, mesh=mesh, axis=sh.AXIS)
    tick(5, f"verify_chain(mesh=) accepts a {len(accs)}-step chain at n = {n}", t)


def _rank(rank: int, world: int, store: str, device_type: str) -> None:
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    sh.init_process_group(rank, world, f"file://{store}", device_type)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
        # nothing here differentiates: inference mode drops autograd's
        # bookkeeping, about a quarter of a CPU rank's dispatch cost
        with torch.inference_mode():
            _phases(rank, world, sh.make_mesh(devices=device_type), dev)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """The five phases on n_devices spawned ranks (see the module
    docstring).  Raises on any failure and when the ranks outlast the sum
    of the phases' budgets."""
    device_type = "cuda" if torch.cuda.is_available() and torch.cuda.device_count() >= n_devices else "cpu"
    if device_type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, no network: loopback only
    t0 = time.perf_counter()
    print(f"dryrun_multichip: {n_devices} ranks on {'NCCL, a card each' if device_type == 'cuda' else 'gloo, the CPU'}, "
          f"n = {WIDTH}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(n_devices, os.path.join(tmp, "store"), device_type),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = t0 + START_BUDGET_S + sum(PHASE_BUDGET_S)
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"dryrun_multichip: ranks still running after {deadline - t0:.0f} s")
    print(f"dryrun_multichip OK: {n_devices} ranks, n = {WIDTH}, {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
