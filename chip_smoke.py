"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the nvcc build of every kernel from csrc/.
  2. kernels: fmul, padd and pdbl at 65,536 lanes and the masked bucket
     reduction at the n = 16384 decider's shape (and a small projective
     shape), each held against its plain PyTorch twin (exact limb equality)
     and, on a sample, against the pure-Python int oracle; median times of
     kernel and twin by CUDA events.
  3. urs: the 16384-generator URS generated on the card, sampled against
     the int oracle.
  4. chain: .chain_cache/chain_16384_10.bin through verify_chain and
     decide_many (both must accept; wall times of the first run and the
     median of three more), tampered copies through both (must reject with
     the reference's messages), and the kernels' launch counts over the two
     first accepting runs (each must be > 0).
The last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without CUDA the script exits 1 before printing anything.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHAIN = os.path.join(REPO, ".chain_cache", "chain_16384_10.bin")
PROFILE_DIR = os.path.join(REPO, "build", "profile")
LANES = 65536
BUCKET_SHAPE = (136, 31 * 256)  # pad', columns of the n = 16384 decider's main group
SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wall(fn) -> float:
    """Host seconds of fn(), the card synchronized before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def phase_device():
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    ck.load(verbose=True)
    build_s = time.perf_counter() - t
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "build_s": round(build_s, 3)})
    return smi


def _base_points(rng, k):
    from halo_accumulation_tpu_torch import fields as F

    G = (F.G_X, F.G_Y)
    return [F.p_mul(int.from_bytes(rng.bytes(40), "little"), G) for _ in range(k)]


def _scaled(P, lam):
    """The same projective points with every coordinate times lam (lazy,
    non-canonical limbs)."""
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops.field import FQ

    return cv.PointVec(*(FQ.mul(c, lam) for c in P))


def phase_kernels(dev):
    """Every kernel against its twin at the main path's shapes."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops import msm as msm_mod
    from halo_accumulation_tpu_torch.ops.field import FQ, L

    rng = np.random.default_rng(SEED)
    res = {}

    def record(name, got, want, ms, plain_ms):
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if not exact:
            raise AssertionError(f"{name}: kernel != plain twin (max |diff| {err})")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # fmul: random lazy limbs (value < 2^257), canonical values mixed in
    lim = rng.integers(0, 1 << 15, size=(2, L, LANES), dtype=np.int64)
    lim[:, 17] &= 3
    a, b = (torch.from_numpy(x).to(dev) for x in lim)
    got = ck.fmul(a, b)
    want = ck.fmul_plain(a, b)
    record("fmul", [got], [want], cuda_time(lambda: ck.fmul(a, b), 20),
           cuda_time(lambda: ck.fmul_plain(a, b), 5))
    sample = rng.choice(LANES, 64, replace=False)
    ai = _raw_ints(a[:, sample])
    bi = _raw_ints(b[:, sample])
    if FQ.to_ints(got[:, sample]) != [x * y % F.Q for x, y in zip(ai, bi)]:
        raise AssertionError("fmul disagrees with the int oracle")

    # padd / pdbl: identity lanes, P == Q, P == -Q, lazy projective limbs
    base = _base_points(rng, 64) + [None]
    ip = rng.integers(0, len(base), LANES)
    iq = rng.integers(0, len(base), LANES)
    kind = rng.integers(0, 4, LANES)  # 0 random, 1 P == Q, 2 P == -Q, 3 Q = identity
    host_p = [base[i] for i in ip]
    host_q = [base[j] if k == 0 else (host_p[n] if k == 1 else (F.p_neg(host_p[n]) if k == 2 else None))
              for n, (j, k) in enumerate(zip(iq, kind))]
    P = cv.from_affine_ints(host_p, dev)
    Q = cv.from_affine_ints(host_q, dev)
    lam1 = FQ.from_ints([int.from_bytes(rng.bytes(40), "little") % (F.Q - 1) + 1 for _ in range(LANES)], dev)
    lam2 = torch.roll(lam1, 1, dims=1)
    P, Q = _scaled(P, lam1), _scaled(Q, lam2)
    got = ck.padd(tuple(P), tuple(Q))
    want = ck.padd_plain(tuple(P), tuple(Q))
    record("padd", got, want, cuda_time(lambda: ck.padd(tuple(P), tuple(Q)), 20),
           cuda_time(lambda: ck.padd_plain(tuple(P), tuple(Q)), 5))
    if cv.to_host(cv.PointVec(*(c[:, sample] for c in got))) != [
        F.p_add(host_p[i], host_q[i]) for i in sample
    ]:
        raise AssertionError("padd disagrees with the int oracle")
    got = ck.pdbl(tuple(P))
    want = ck.pdbl_plain(tuple(P))
    record("pdbl", got, want, cuda_time(lambda: ck.pdbl(tuple(P)), 20),
           cuda_time(lambda: ck.pdbl_plain(tuple(P)), 5))
    if cv.to_host(cv.PointVec(*(c[:, sample] for c in got))) != [
        F.p_add(host_p[i], host_p[i]) for i in sample
    ]:
        raise AssertionError("pdbl disagrees with the int oracle")

    # bucket_masked at the n = 16384 decider's main group: lanes 18 (packed
    # affine), pad' 136, 31 windows x 256 buckets; every slot holds a point,
    # so slots outside [off, off + len) are foreign and must be ignored
    pts = [p for p in base if p is not None]
    xs = FQ.from_ints([p[0] for p in pts], dev)
    ys = FQ.from_ints([p[1] for p in pts], dev)
    planes = msm_mod.planes_from_affine(xs, ys)  # (18, 64)
    padp, cols = BUCKET_SHAPE
    src = torch.from_numpy(rng.integers(0, len(pts), (padp, cols))).to(dev)
    M = planes[:, src]  # (18, padp, cols)
    off = rng.integers(0, 8, cols)
    ln = rng.integers(0, padp - 7, cols)  # len <= pad = padp - 8
    ln[rng.random(cols) < 0.05] = 0  # dead columns
    meta = torch.from_numpy((off | (ln << 3)).reshape(1, cols)).to(dev)
    got = ck.bucket_masked(M, meta)
    want = ck.bucket_masked_plain(M, meta)
    record("bucket_masked", got, want, cuda_time(lambda: ck.bucket_masked(M, meta), 10),
           cuda_time(lambda: ck.bucket_masked_plain(M, meta), 2))
    srcn = src.cpu().numpy()
    for col in rng.choice(cols, 8, replace=False):
        acc = None
        for p in range(off[col], off[col] + ln[col]):
            acc = F.p_add(acc, pts[srcn[p, col]])
        if cv.to_host(cv.PointVec(*(c[:, col : col + 1] for c in got)))[0] != acc:
            raise AssertionError("bucket_masked disagrees with the int oracle")
    # lanes 54 (projective, lazy limbs) at a small shape
    padp2, cols2 = 16, 256
    src2 = torch.from_numpy(rng.integers(0, LANES, (padp2, cols2))).to(dev)
    M2 = torch.cat([c[:, src2] for c in P])  # (54, padp2, cols2)
    off2 = rng.integers(0, 8, cols2)
    ln2 = rng.integers(0, padp2 - 7, cols2)
    meta2 = torch.from_numpy((off2 | (ln2 << 3)).reshape(1, cols2)).to(dev)
    g2 = ck.bucket_masked(M2, meta2)
    w2 = ck.bucket_masked_plain(M2, meta2)
    if not all(torch.equal(g, w) for g, w in zip(g2, w2)):
        raise AssertionError("bucket_masked (54 lanes) != plain twin")
    src2n = src2.cpu().numpy()
    for col in rng.choice(cols2, 4, replace=False):
        acc = None
        for p in range(off2[col], off2[col] + ln2[col]):
            acc = F.p_add(acc, host_p[src2n[p, col]])
        if cv.to_host(cv.PointVec(*(c[:, col : col + 1] for c in g2)))[0] != acc:
            raise AssertionError("bucket_masked (54 lanes) disagrees with the int oracle")
    emit({"phase": "kernels", "lanes": LANES, "bucket_shape": [L, padp, cols], **res})
    return res


def _raw_ints(t):
    from halo_accumulation_tpu_torch.ops.field import limb_array_to_ints

    return limb_array_to_ints(t.cpu().numpy())


def phase_urs(dev):
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch import pp as pp_mod
    from halo_accumulation_tpu_torch.ops.field import FQ

    t = time.perf_counter()
    pp = pp_mod.get_pp(16384, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    G = (F.G_X, F.G_Y)
    idx = [0, 1, 2, 4095, 8191, 16383]
    xs = FQ.to_ints(pp.gs_x[:, idx])
    ys = FQ.to_ints(pp.gs_y[:, idx])
    for i, x, y in zip(idx, xs, ys):
        if (x, y) != F.p_mul(pp_mod.gen_scalar(i + 2), G):
            raise AssertionError(f"URS generator {i} disagrees with the int oracle")
    if pp.s != F.p_mul(pp_mod.gen_scalar(0), G) or pp.h != F.p_mul(pp_mod.gen_scalar(1), G):
        raise AssertionError("URS S/H disagree with the int oracle")
    emit({"phase": "urs", "n": 16384, "gen_s": round(gen_s, 3), "sampled": idx})
    return pp


def _expect_reject(fn, msg: str) -> None:
    try:
        fn()
    except ValueError as e:
        if str(e) != msg:
            raise AssertionError(f"rejected with {str(e)!r}, expected {msg!r}") from e
        return
    raise AssertionError(f"tampered input accepted, expected {msg!r}")


def phase_chain(pp, smi):
    from halo_accumulation_tpu_torch import acc as acc_mod
    from halo_accumulation_tpu_torch import chain
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    d, qss, accs = chain.load_chain(CHAIN)
    K = len(accs)

    paths = {
        "verify_chain": lambda: chain.verify_chain_fast(d, qss, accs, pp),
        "decide_many": lambda: chain.verify_chain_slow(accs, pp),
    }
    first, launches, warm = {}, {}, {}
    for path, fn in paths.items():
        ck.reset_launches()
        first[path] = wall(fn)
        launches[path] = ck.launch_counts()
        missing = [k for k, v in launches[path].items() if v == 0]
        if missing:
            raise AssertionError(f"{path} launched no {missing} kernel")
    for path, fn in paths.items():
        warm[path] = float(np.median([wall(fn) for _ in range(3)]))

    def bumped(a):
        return acc_mod.Accumulator(a.C_bar, a.d, a.z, (a.v + 1) % F.R, a.pi, a.pi_V)

    _expect_reject(lambda: chain.verify_chain_fast(d, qss, accs[:-1] + [bumped(accs[-1])], pp),
                   f"h(z) != v at step {K - 1}")
    _expect_reject(lambda: chain.verify_chain_slow([bumped(accs[0]), accs[1]], pp),
                   "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)")
    emit({"phase": "chain", "chain": os.path.basename(CHAIN), "d": d, "K": K,
          "verify_chain_s": first["verify_chain"], "decide_many_s": first["decide_many"],
          "verify_chain_warm_s": warm["verify_chain"], "decide_many_warm_s": warm["decide_many"],
          "card": smi, "launches": launches, "tamper_rejected": 2})
    return paths, warm, launches


def phase_profile(paths, warm, smi) -> None:
    """One warm run of each path under torch.profiler and one under
    cProfile, tables written to PROFILE_DIR.  Device busy time is
    the union of the trace's device intervals (kernels, copies, memsets);
    idle share is 1 - busy / wall, against the profiled wall time and
    against the unprofiled warm median of phase 4."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(PROFILE_DIR, exist_ok=True)
    for path, fn in paths.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        if not dev:
            raise AssertionError(f"{path}: the trace holds no device activity")
        busy_us, hi = 0.0, float("-inf")
        items: dict[str, list] = {}
        for start, end, name in dev:
            busy_us += max(0.0, end - max(start, hi))
            hi = max(hi, end)
            it = items.setdefault(name, [0, 0.0])
            it[0] += 1
            it[1] += end - start
        top = sorted(items.items(), key=lambda kv: -kv[1][1])
        with open(os.path.join(PROFILE_DIR, f"profile_{path}.txt"), "w") as f:
            f.write(f"{smi}\n{path}: wall {prof_wall:.6f} s, device busy {busy_us / 1e3:.3f} ms, "
                    f"{len(dev)} device events\n\n")
            for name, (calls, us) in top:
                f.write(f"{us / 1e3:12.3f} ms {calls:7d}  {name}\n")
            f.write("\n" + prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
        busy_s = busy_us / 1e6
        # host: a second warm run under cProfile, ranked by own time
        prof_host = cProfile.Profile()
        prof_host.enable()
        wall(fn)
        prof_host.disable()
        st = pstats.Stats(prof_host)
        st.dump_stats(os.path.join(PROFILE_DIR, f"host_{path}.pstats"))
        own = sorted(((tt, ct, f"{os.path.basename(f)}:{ln}({fn_name})")
                      for (f, ln, fn_name), (_, _, tt, ct, _) in st.stats.items()), reverse=True)
        replay_s = sum(ct for (f, _, fn_name), (_, _, _, ct, _) in st.stats.items()
                       if fn_name == "succinct_check_parts" and f.endswith("pcdl.py"))
        emit({"phase": "profile", "path": path, "card": smi, "wall_s": prof_wall,
              "unprofiled_warm_s": warm[path], "device_busy_ms": busy_us / 1e3,
              "device_events": len(dev), "idle_share": 1 - busy_s / prof_wall,
              "idle_share_unprofiled": 1 - busy_s / warm[path],
              "top_device_ms": [[n[:80], c, us / 1e3] for n, (c, us) in top[:8]],
              "host_cprofile_s": st.total_tt, "host_replays_s": replay_s,
              "host_top_own_s": [[name, tt] for tt, _, name in own[:8]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_device()
    res = phase_kernels(dev)
    pp = phase_urs(dev)
    paths, warm, launches = phase_chain(pp, smi)
    phase_profile(paths, warm, smi)
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    kernels = []
    for name, k in ck.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                        "launches": sum(n[name] for n in launches.values()),
                        "launches_by_path": {p: n[name] for p, n in launches.items()}, **res[name]})
    emit({"phase": "done", "total_s": round(time.perf_counter() - t0, 3)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
