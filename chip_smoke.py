"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card (nvidia-smi name, power limit and top SM clock), torch
     and CUDA versions, and the nvcc build of every kernel from csrc/;
     then ptxas: each kernel function's registers and spills.
  2. native: the native host backend (hostops.use_native() must be True:
     the run fails if it gave way to the Python oracle), its g++ build
     seconds, and its ops on a sample against the fields.py oracle; then
     urs: the 16384-generator URS generated on the card, sampled against
     the int oracle, written to the URS disk cache (HALO_TPU_URS_CACHE is
     build/urs_cache, emptied at the start of the run) and read back.
  3. kernels: fmul and padd at 65,536 lanes (both timed over ten launches
     queued), fmul also on every pair of its edge lanes (fmul_edge_limbs),
     timed at 64, 128 and 256 threads a block, and with each of the ten
     launches on its own inputs (FMUL_ROTATE pairs, more than the L2 holds)
     beside torch.add of the same int64 planes (the same bytes, no
     arithmetic);
     padd held to its twin from 1 to 79,360 lanes, edge lanes first
     (identity, P == Q, P == -Q), reported also at the Horner combine's 10
     lanes and timed from 1 to 79,360 lanes; pdbl with k = 1, 4, 8
     doublings per launch at 1, 10, 32 and 65,536 lanes, reported at
     decide_many's Horner combine (10 lanes, k = 8) and timed at k = 8
     from 1 to 65,536 lanes (ten launches queued); the masked bucket
     reduction at the n = 16384 decider's shape with a uniform fill, at
     both deciders' real fills (digits of random scalars over the URS,
     through the sort-payload MSM's own gather) and at the prover's
     projective round shape, timed at every split; and the row-permutation
     bucket kernel at the n = 16384 main group's shapes (40 and 64 lanes,
     128 slots, 7936 columns, URS rows with about 5 % sentinel slots) and
     at its folded top window's (48 slots, 1024 columns), held to its twin
     and timed at every split; finv (inversion by divsteps) at 1, 2, 10,
     1,024 and 65,536 lanes of Fq and Fr, the edge lanes first (0, 1,
     p - 1, 2^254, lazy limbs at or above p), timed at every width, the
     path's two lanes (a round's L and R) its row; rho_round (a round's
     challenge) on 64 random (xi, L, R) triples and the boundary cases (L
     or R the identity, y = (q - 1) / 2 and (q + 1) / 2).
     Each is held against its plain PyTorch twin (its limbs canonical and
     equal to FQ.canon of the twin's, see _same) and, on a sample, against
     the pure-Python int oracle; median times of kernel and twin by CUDA
     events, and each kernel's bound: the larger of the least bytes its
     function moves over the memory rate and the least 32-bit multiplies
     (rho_round: logic operations) it needs over the IMAD rate (see
     MIN_MULS_FMUL, finv_least_ops and KECCAK_OPS32).
  4. prove: build_chain(default_rng(7), 16384, 2) under sortrows with the
     device-transcript open (the defaults), under sortrows with
     HALO_TPU_OPEN_DEVICE=0, and under rowperm (which opens on the host
     transcript); each must equal the first two step records of
     .chain_cache/chain_16384_10.bin byte for byte (the JAX package built
     that file from the same rng; the depth is cut from its 10 steps to 2,
     and step 1 already folds [acc, q]), and none may take open_'s _safe
     rebuild.  Each device open runs as one captured CUDA graph
     (runtime.graphed, the default).  Then one device open at n = 16384
     under torch.profiler: its device-to-host copies (expected: one, the
     proof), host-to-device copies (one, the graph's static input) and
     graph replays (one) are counted, and its synchronizing calls by source
     line; the same open with its body run eagerly under
     torch.cuda.set_sync_debug_mode("error") must not sync.  Then api: the
     package docstring's example through the façade (setup, commit, open,
     check, verify_chain).
  5. chain: .chain_cache/chain_16384_10.bin through verify_chain and
     decide_many, first under sortrows (each verdict one CUDA graph), then
     under rowperm and under staged (eager), each must accept; wall times of the first
     run and the median of three more, and under sortrows three more with
     the host ops forced onto the Python oracle; then tampered copies of
     the same shape (replays of the good runs' graphs: the stale-input
     check) and one-step prefixes, which must reject with the reference's
     messages, REJECT_TEXTS.
     Then staged: under HALO_TPU_MSM_IMPL=staged, build_chain(default_rng(7),
     16384, 1) must equal the file's first step byte for byte and both
     verifiers must accept it; a commitment whose coefficients are all
     equal (every window's one live bucket holds all n points, past any
     pinned pad) at n = 16384 and 65,536 (a URS made on the card) under
     each of the three settings must take the staged _msm_measured (points
     chunked to fit the scatter budget) and equal native.msm, with its
     seconds and peak reserved memory; msm_sharded on a one-rank NCCL mesh
     must equal msm at 16,384 points, and check_device(mesh=) the verdict
     of check_device on the file's first claim and on a tampered copy.
     Then mesh, on the same one-rank NCCL group (formed once for both and
     destroyed after): open_(mesh=) at n = 16384 with hiding must write the
     single-device open's bytes for a copy of the same rng;
     succinct_check_batch(mesh=) on the file's 19 claims must accept, and
     reject a copy with one v off by one at that row, as without a mesh;
     verify_chain(mesh=) must accept the file and reject four tampered
     copies (v of the last step, c of step 4's fresh claim, G0/G1 and
     G2/G3 swapped in the key) with REJECT_TEXTS, as without a mesh;
     pmul_shared on 1,024 lanes must equal fields.p_mul on a sample.
  6. profile: one more sortrows run of each chain path, and one prover
     step (build_chain with k = 1) under each of the prove phase's
     settings, under torch.profiler and under cProfile (tables in
     build/profile/).
  7. graphs: the same paths with graphs on and off
     (runtime._eager_graphs) in turns: warm host seconds, then device
     busy, idle share and device events under torch.profiler; every
     verdict body run eagerly under set_sync_debug_mode("error"); each
     graph's capture seconds; the card's reserved memory at the end.
  8. chains: every file under .chain_cache/ (CHAIN_FILES: n = 512 to 16384
     at K = 10 and 100, and 65536 at K = 4), on a URS sliced from the
     16384- or 65536-generator one: build_chain(default_rng(7), n, 1) must
     equal the first step of every file of that n byte for byte; under
     sortrows, and under rowperm on the files with K <= 10, verify_chain
     and decide_many must accept the file (first and warm seconds;
     decide_many in chunks of at most acc.KC = 10) and reject four
     tampered copies with REJECT_TEXTS (_chain_rejects).  One line a file
     with the peak reserved memory from a reset just before its verifiers,
     then the phase's seconds.
Every path runs with the launch counts set to 0 just before it and read
just after it, and must launch the kernels its pipeline runs: bucket_accum
on the rowperm paths, bucket_masked on the sortrows paths, finv and
rho_round on the device-transcript prove; the <kernel>_widths lines give
each path's launches of padd, pdbl, bucket_masked, bucket_accum and finv
by width.  The run fails if any kernel has no launch over all paths.  The
last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
without CUDA the script exits 1 before printing anything.
"""

from __future__ import annotations

import contextlib
import cProfile
import hashlib
import json
import os
import pstats
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHAIN = os.path.join(REPO, ".chain_cache", "chain_16384_10.bin")
URS_CACHE = os.path.join(REPO, "build", "urs_cache")  # HALO_TPU_URS_CACHE for this run, emptied at its start
PROFILE_DIR = os.path.join(REPO, "build", "profile")
LANES = 65536
BUCKET_SHAPE = (136, 31 * 256)  # pad', columns of the n = 16384 decider's main group
ROWPERM_SHAPE = (128, 31 * 256)  # pad, columns of the n = 16384 rowperm main group
PROVER_ROUND_SHAPE = (104, 2 * 31 * 256)  # pad', columns of the prover's dual-route round at n = 16384
PADD_CHECKED = (1, 2, 5, 10, 30, 7936, 65536, 79360)  # padd widths held to the twin
PADD_TIMED = (1, 2, 10, 30, 1024, 7936, 15872, 32768, 65536, 79360)  # padd widths timed
PADD_PATH_LANES = 10  # decide_many's Horner combine: one add per window over its ten stacked deciders
PDBL_CHECKED = (1, 10, 32, 65536)  # pdbl widths held to the twin at k = 1, 4, 8
PDBL_TIMED = (1, 10, 32, 1024, 16384, 65536)  # pdbl widths timed at k = PDBL_K
PDBL_K = 8
FMUL_THREADS_TIMED = (64, 128, 256)  # fmul block sizes timed at LANES
FMUL_ROTATE = 10  # input pairs of the L2-rotated fmul timing: 10 x 18.9 MB, the H100's L2 holds 50 MB
PDBL_PATH_LANES = 10  # decide_many's Horner combine: its ten stacked deciders, PDBL_K = c doublings a window
FINV_CHECKED = (1, 2, 10, 1024, 65536)  # finv widths held to the twin, Fq and Fr (1,024: fold_basis's to_affine)
FINV_PATH_LANES = 2  # to_affine of a round's L and R (a round's challenge inverts 1 lane, fold_basis 1,024)
RHO_RANDOM = 64  # random (xi, L, R) triples rho_round is held to its twin on
QUEUE_CYCLES = 10_000_000  # about 5 ms of SM clock: covers the host's enqueue of ten launches
SPLITS = (1, 2, 4, 8, 16)  # threads per column of both bucket kernels, all held to the twin and timed
ACCUM_TOP_SHAPE = (48, 1024)  # pad, columns of the rowperm MSM's folded top window at n = 16384
TWIN_MAX_LANES = 1 << 18  # widest bucket_masked_plain run (T * cols lanes): its multiplies take 16 GB at 2^20
N = 16384
PROVE_STEPS = 2
GRAPH_REPS = (7, 3)  # warm runs per mode of the graphs phase: chain paths, prover steps
SEED = 20261016
MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s
IMAD_PER_CLOCK_SM = 64  # 32-bit integer multiply(-add)s per clock per SM, compute capability 9.0
SMS = 132
# The bound counts the least work of each function, not of this
# implementation.  Bytes: an Fq or Fr value is 32 bytes (255 bits), an
# affine point 64, a projective one 96, a row index 4 (N + 1 < 2^32).
# Operations: 32-bit multiplies (each 32 x 32 -> 64-bit product counted as
# one IMAD, which is a lower bound).  A 255-bit multiply modulo this q, on
# s = 8 32-bit words, the fewer of two designs on q's own words (q = 2^254 +
# c, c < 2^126: word 0 of q is 1, words 1 to 3 are c's, words 4 to 6 are 0,
# word 7 is 2^30):
#   Montgomery CIOS, R = 2^256: s^2 = 64 products for a b; per word of the
#     reduction m = -t0 needs none (q == 1 mod 2^32), and m q needs three,
#     for words 1 to 3 (words 0 and 7 are 1 and 2^30: shifts): 64 + 8 x 3
#     = 88;
#   pseudo-Mersenne, 2^256 == -4c: 64 for a b, the high half times 4c (8
#     words x its words 1 to 3; word 0 is 4, a shift) 24, the fold's four
#     high words times 4c again 12: 100, and a product-free final
#     correction.
# So 88.  A square a a needs only s (s + 1) / 2 = 36 products (each cross
# product once, doubled by a shift), then the same 24 for Montgomery's
# reduction: 60.  Complete formulas for a = 0 (Renes-Costello-Batina 2016):
# a projective add (Alg. 7) 12 multiplies, a mixed add of an affine point
# (Alg. 8) 11, a double (Alg. 9) 6 multiplies and 2 squares (y y, z z); the
# multiplies by 3b = 15 are shifts and adds.
FQ_BYTES = 32
MIN_MULS_FMUL = 64 + 8 * 3
MIN_MULS_SQR = 8 * 9 // 2 + 8 * 3
MIN_MULS_PADD = 12 * MIN_MULS_FMUL
MIN_MULS_MADD = 11 * MIN_MULS_FMUL
MIN_MULS_PDBL = 6 * MIN_MULS_FMUL + 2 * MIN_MULS_SQR
# This implementation's own count, from csrc/field.cuh (8 32-bit words,
# pseudo-Mersenne): a multiply is 64 products, 24 and 12 in the two folds by
# 4c and 3 in finish (the small multiple of c it subtracts) = 103; mul_small
# 8 + 3; add and sub 3 each (finish).  Reported beside the bound as
# impl_muls32, to show how much of the gap is the implementation's;
# tests/test_torch_field_words.py counts them on a model of field.cuh.
IMPL_MULS_FMUL = 103
IMPL_MULS_SMALL = 11
IMPL_MULS_ADD = 3
# curve.cuh padd: 12 mul, 2 mul_small, 5 sub, 14 add; pdbl: 8 mul, 3
# mul_small, 1 sub, 3 add (the loads' and stores' conversions not counted)
IMPL_MULS_PADD = 12 * IMPL_MULS_FMUL + 2 * IMPL_MULS_SMALL + (5 + 14) * IMPL_MULS_ADD
IMPL_MULS_PDBL = 8 * IMPL_MULS_FMUL + 3 * IMPL_MULS_SMALL + (1 + 3) * IMPL_MULS_ADD
# finv: a^-1 mod p.  Its least work is the smaller of two counts: Fermat's
# a^(p - 2) on the shortest chain known here for p - 2, the best
# left-to-right sliding window (finv_least_chain: k = 4, 255 squarings and
# 34 multiplies for both fields), a square at MIN_MULS_SQR and a multiply at
# MIN_MULS_FMUL; and Bernstein-Yang divsteps (FINV_DIVSTEP_OPS32): hddivstep
# needs at most FINV_DIVSTEPS = 590 of them for inputs below 2^256
# (Wuille's bound, libsecp256k1's doc/safegcd_implementation.md), each
# DIVSTEP_OPS = 21 32-bit operations with sm_90's three-input LOP3 and
# IADD3 (csrc/finv.cu's step: the two masks 3, three conditional adds to
# g, q, r 6, zeta 2, three conditional adds to f, u, v 6, three shifts 3,
# and the swap mask 1), and ceil(590 / FINV_BATCH) batches whose 2 x 2
# matrix costs MATRIX_MULS products: 36 on (f, g) and 36 on (d, e) over
# nine 30-bit limbs, and 8 for the multiples of p on p's limbs 1 to 4 (limb
# 0 is 1, limbs 5 to 7 are 0, limb 8 is 2^14: no products).  csrc/finv.cu
# runs 20 batches of 30, each divstep as 27 two-input operations as
# written: FINV_IMPL_OPS32 a lane, reported as impl_muls32;
# tests/test_torch_field_words.py counts both on a model of finv.cu.
FINV_DIVSTEPS = 590
FINV_BATCH = 30
FINV_BATCHES = 20
DIVSTEP_OPS = 21
DIVSTEP_IMPL_OPS = 27
MATRIX_MULS = 36 + 36 + 8
FINV_IMPL_OPS32 = FINV_BATCHES * (FINV_BATCH * DIVSTEP_IMPL_OPS + MATRIX_MULS)
FINV_DIVSTEP_OPS32 = FINV_DIVSTEPS * DIVSTEP_OPS + -(-FINV_DIVSTEPS // FINV_BATCH) * MATRIX_MULS


def sliding_window_chain(e: int, k: int) -> tuple[int, int]:
    """(squarings, multiplies) of the left-to-right sliding-window chain
    for e with windows of at most k bits: a table of the odd powers up to
    2^k - 1 (one squaring, 2^(k-1) - 1 multiplies), the first window read
    from it, then a squaring per bit and a multiply per later window."""
    sq, mu = (1, (1 << (k - 1)) - 1) if k > 1 else (0, 0)
    bits = bin(e)[2:]
    i, first = 0, True
    while i < len(bits):
        if bits[i] == "0":
            sq, i = sq + 1, i + 1
            continue
        j = min(i + k, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            sq, mu = sq + j - i, mu + 1
        first, i = False, j
    return sq, mu


def finv_least_chain(p: int) -> tuple[int, int]:
    """(squarings, multiplies) of the cheapest sliding-window chain for
    p - 2 over k = 1 to 8, weighed at MIN_MULS_SQR and MIN_MULS_FMUL."""
    return min((sliding_window_chain(p - 2, k) for k in range(1, 9)),
               key=lambda c: c[0] * MIN_MULS_SQR + c[1] * MIN_MULS_FMUL)


def finv_least_ops(p: int) -> int:
    """The least 32-bit operations of one inversion mod p: divsteps or
    Fermat's shortest chain, whichever is fewer."""
    sq, mu = finv_least_chain(p)
    return min(FINV_DIVSTEP_OPS32, sq * MIN_MULS_SQR + mu * MIN_MULS_FMUL)


# rho_round: one keccak-f[1600], 24 rounds on 25 64-bit lanes, each lane two
# 32-bit words on the card's 32-bit integer pipes (64 a clock per SM, the
# IMAD rate).  The least count a round, with sm_90's three-input LOP3 (any
# function of three words) and funnel shifts (SHF: a 64-bit rotation is two):
# theta's column parities 5 x 2 words x 2 LOP3 (five inputs) = 20, its five
# rotations by 1 10 SHF, and each lane's a ^ C[x-1] ^ rot(C[x+1]) one LOP3 a
# word 50; rho 24 rotations (lane 0's offset is 0, none is 32) 48 SHF; pi
# none (renaming); chi a ^ (~b & c) one LOP3 a word 50; iota 2: 180 a round.
# The absorb into the zero state and the digest's reduction mod r are not
# counted.  Bytes: xi, the four coordinates and the digest, 32 bytes each,
# and the two flag bytes
KECCAK_OPS32 = 24 * (20 + 10 + 50 + 48 + 50 + 2)
# csrc/rho_round.cu runs a round on 25 threads of a warp, a lane each; as
# written, a thread's round is a store of its lane and six loads (two
# columns of the state, each two 16-byte loads and an 8-byte one), theta's
# 16 xors, 2 funnel shifts and 4 xors, rho's 2 selects and 2 funnel shifts,
# iota's 2 masks, 6 shuffles for pi and chi, and chi's 8 (not, and and two
# xors a word): 49 32-bit operations (what nvcc fuses into LOP3 is not
# counted, nor the __syncwarp); reported beside the bound as impl_muls32
KECCAK_IMPL_OPS32 = 24 * 25 * 49
RHO_BYTES = 6 * 32 + 2
# The JAX package's rejection texts that phase 5 provokes ({k} a step, {b}
# a batch index or step, as in halo_accumulation_tpu/acc.py and pcdl.py)
REJECT_TEXTS = {
    "v": "h(z) != v at step {k}",
    "row": "C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})",
    "c_bar": "C_bar' != C_bar at step {k}",
    "z": "z' != z at step {k}",
    "d": "d_i != d at step {k}",
    "length": "proof length mismatch",
    "u0": "U_0 != PCDL.Commit(h_0) at step {b}",
    "u": "U != CM.Commit(ck, h_vec)",
}
# the kernels each path must launch: its MSM setting's bucket kernel, the
# curve kernels, and on the verifier paths the field multiply of peq
MUST_LAUNCH = {"sortrows": {"padd", "pdbl", "bucket_masked"},
               "rowperm": {"padd", "pdbl", "bucket_accum"},
               "staged": {"padd", "pdbl"}}
VERIFY_ALSO = {"fmul"}
OPEN_DEVICE_ALSO = {"finv", "rho_round"}  # the device-transcript open's challenge and inversions
WIDTHS_KEPT = ("padd", "pdbl", "bucket_masked", "bucket_accum", "finv")  # kernels whose launches by width each path reports


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time(fn, reps: int, queued: bool = False) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events.  queued:
    the card first sleeps QUEUE_CYCLES, so the host enqueues all of fn's
    launches before the start event fires and the events read the device's
    time alone, not the wrappers' dispatch between narrow launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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


@contextlib.contextmanager
def env(name: str, value: str):
    """Environment variable name set to value for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def counted(path: str, must: set, fn, launches: dict, widths: dict) -> float:
    """Wall seconds of one run of fn with the launch counts zeroed just
    before and read just after (into launches[path], and the WIDTHS_KEPT
    kernels' launches by width into widths[kernel][path]); the path must
    launch every kernel in must."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    s = wall(fn)
    launches[path] = ck.launch_counts()
    for k in WIDTHS_KEPT:
        widths.setdefault(k, {})[path] = ck.launch_widths()[k]
    missing = sorted(k for k in must if launches[path][k] == 0)
    if missing:
        raise AssertionError(f"{path} launched no {missing} kernel: {launches[path]}")
    return s


def phase_device():
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(name_limit, flush=True)
    sm_mhz = float(smi("clocks.max.sm"))
    t = time.perf_counter()
    ck.load()
    build_s = time.perf_counter() - t
    emit({"phase": "device", "nvidia_smi": name_limit, "clocks_max_sm_mhz": sm_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "build_s": round(build_s, 3)})
    # ptxas -v of every kernel function: registers (entry functions), stack
    # frame and spill bytes
    emit({"phase": "ptxas", **ck.ptxas_report()})
    return name_limit, sm_mhz


def bound(nbytes: float, muls: float, impl_muls: float, sm_mhz: float) -> dict:
    """The least time the card needs for the function: its least bytes over
    the memory rate or its least 32-bit multiplies over the IMAD rate,
    whichever is larger.  impl_muls (this implementation's multiplies) is
    reported beside it and bounds nothing."""
    t_bytes = nbytes / MEM_RATE
    t_ops = muls / (SMS * IMAD_PER_CLOCK_SM * sm_mhz * 1e6)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "muls32": muls, "impl_muls32": impl_muls}


def phase_native(smi):
    """The native host backend: hostops must take it (the run fails if it
    gave way to the Python oracle), and its ops equal fields.py's on a
    sample.  build_s: the g++ build in this process (None: an existing
    build of the same source was reused)."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch import hostops, native

    t = time.perf_counter()
    if not hostops.use_native():
        raise AssertionError("hostops.use_native() is False: the host ops fell back to the Python oracle")
    first_use_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 1)
    G = (F.G_X, F.G_Y)
    ks = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(8)]
    pts = [F.p_mul(k, G) for k in ks]
    checks = {
        "point_add": [native.point_add(P, Q) == F.p_add(P, Q) for P, Q in zip(pts, pts[1:] + [None])]
        + [native.point_add(pts[0], F.p_neg(pts[0])) is None, native.point_add(pts[0], pts[0]) == F.p_add(pts[0], pts[0])],
        "scalar_mul": [native.scalar_mul(k, P) == F.p_mul(k, P) for k, P in zip(ks, pts[::-1])]
        + [native.scalar_mul(0, pts[0]) is None, native.scalar_mul(F.R - 1, pts[1]) == F.p_neg(pts[1])],
        "msm": [native.msm(ks, pts) == F.p_msm(ks, pts)],
        "sha3": [native.sha3(m) == hashlib.sha3_256(m).digest() for m in (b"", rng.bytes(135), rng.bytes(1000))],
    }
    bad = [k for k, v in checks.items() if not all(v)]
    if bad:
        raise AssertionError(f"native {bad} disagree with the fields.py oracle")
    G1 = F.p_mul(ks[0], G)
    t = time.perf_counter()
    for _ in range(20):
        native.scalar_mul(ks[1], G1)
    native_us = (time.perf_counter() - t) / 20 * 1e6
    t = time.perf_counter()
    F.p_mul(ks[1], G1)
    oracle_us = (time.perf_counter() - t) * 1e6
    emit({"phase": "native", "card": smi, "use_native": True, "build_s": native.build_s,
          "first_use_s": first_use_s, "library": os.path.relpath(native.lib_path(), REPO),
          "checked": {k: len(v) for k, v in checks.items()},
          "host_p_mul_us": {"native": native_us, "oracle": oracle_us}})


def phase_urs(dev):
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch import pp as pp_mod
    from halo_accumulation_tpu_torch.ops.field import FQ

    t = time.perf_counter()
    pp = pp_mod.get_pp(N, dev)  # generated (the cache is empty) and written to URS_CACHE
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    cached = pp_mod.cache_dir() / f"urs_{N}.npz"
    t = time.perf_counter()
    back = pp_mod._load(cached, N, dev)
    read_s = time.perf_counter() - t
    if not (torch.equal(back.gs_x, pp.gs_x) and torch.equal(back.gs_y, pp.gs_y) and (back.s, back.h) == (pp.s, pp.h)):
        raise AssertionError(f"{cached} does not read back as the URS written")
    G = (F.G_X, F.G_Y)
    idx = [0, 1, 2, 4095, 8191, N - 1]
    xs = FQ.to_ints(pp.gs_x[:, idx])
    ys = FQ.to_ints(pp.gs_y[:, idx])
    for i, x, y in zip(idx, xs, ys):
        if (x, y) != F.p_mul(pp_mod.gen_scalar(i + 2), G):
            raise AssertionError(f"URS generator {i} disagrees with the int oracle")
    if pp.s != F.p_mul(pp_mod.gen_scalar(0), G) or pp.h != F.p_mul(pp_mod.gen_scalar(1), G):
        raise AssertionError("URS S/H disagree with the int oracle")
    emit({"phase": "urs", "n": N, "gen_s": round(gen_s, 3), "sampled": idx,
          "cache_file": os.path.relpath(str(cached), REPO), "cache_bytes": cached.stat().st_size, "cache_read_s": read_s})
    return pp


def _base_points(rng, k):
    from halo_accumulation_tpu_torch import fields as F

    G = (F.G_X, F.G_Y)
    return [F.p_mul(int.from_bytes(rng.bytes(40), "little"), G) for _ in range(k)]


def _point_pairs(rng, dev):
    """LANES pairs (P, Q) of lazy projective points on the card: each lane
    random, P == Q, P == -Q or Q the identity, P the identity in about one
    lane of 65.  -> (base points, P, Q, host P, host Q, kind per lane)."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import curve as cv

    base = _base_points(rng, 64) + [None]
    ip = rng.integers(0, len(base), LANES)
    iq = rng.integers(0, len(base), LANES)
    kind = rng.integers(0, 4, LANES)  # 0 random, 1 P == Q, 2 P == -Q, 3 Q = identity
    host_p = [base[i] for i in ip]
    host_q = [base[j] if k == 0 else (host_p[n] if k == 1 else (F.p_neg(host_p[n]) if k == 2 else None))
              for n, (j, k) in enumerate(zip(iq, kind))]
    lam1 = _rand_lam(rng, LANES, dev)
    lam2 = torch.roll(lam1, 1, dims=1)
    P = _scaled(cv.from_affine_ints(host_p, dev), lam1)
    Q = _scaled(cv.from_affine_ints(host_q, dev), lam2)
    return base, P, Q, host_p, host_q, kind


def _scaled(P, lam):
    """The same projective points with every coordinate times lam (lazy,
    non-canonical limbs)."""
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops.field import FQ

    return cv.PointVec(*(FQ.mul(c, lam) for c in P))


def _rand_lam(rng, n, dev):
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops.field import FQ

    return FQ.from_ints([int.from_bytes(rng.bytes(40), "little") % (F.Q - 1) + 1 for _ in range(n)], dev)


def _same(what: str, got, want, field=None) -> int:
    """Hold a kernel's output to its plain twin: every coordinate canonical
    (clean 15-bit limbs of a value below the modulus, which field.canon
    leaves as they are; field FQ unless named) and equal to field.canon of
    the twin's, limb for limb.  Canonical form is unique, so this holds the
    values as strictly as limb equality did; it gives up only the twin's
    lazy representative, which the kernels' 8-word arithmetic does not
    keep.  -> the largest limb difference (0)."""
    from halo_accumulation_tpu_torch.ops.field import FQ

    field = FQ if field is None else field
    err = 0
    for g, w in zip(got, want):
        cw = field.canon(w)
        if g.numel():
            err = max(err, int((g - cw).abs().max()))
        if not torch.equal(field.canon(g), g):
            raise AssertionError(f"{what}: kernel limbs are not canonical")
        if not torch.equal(g, cw):
            raise AssertionError(f"{what}: kernel != FQ.canon(plain twin) (max |diff| {err})")
    return err


def fmul_edge_limbs() -> list[list[int]]:
    """The fmul edge lanes as 18 limbs each: 0, 1, q - 1, q, q + 1, 2^254,
    2q - 1, 2q, 2^255 - 1 (the top of the kernels' 8-word invariant) and
    2^257 - 1 (the boundary's bound) in clean limbs, and the boundary's lazy
    maximum, every limb at 0x8008 (nearly clean) with limb 17 at 2."""
    from halo_accumulation_tpu_torch import fields as F

    q = F.Q
    vals = [0, 1, q - 1, q, q + 1, 1 << 254, 2 * q - 1, 2 * q, (1 << 255) - 1, (1 << 257) - 1]
    clean = [[(v >> (15 * i)) & 0x7FFF for i in range(17)] + [v >> 255] for v in vals]
    return clean + [[0x8008] * 17 + [2]]


def _doubled(P, k: int):
    """2^k P of host points, on the int oracle."""
    from halo_accumulation_tpu_torch import fields as F

    for _ in range(k):
        P = [F.p_add(p, p) for p in P]
    return P


def _pdbl_widths(P, host_p, sm_mhz) -> dict:
    """pdbl with k doublings per launch: held to pdbl_plain(P, k) for
    k = 1, 4, 8 at the PDBL_CHECKED widths, a few lanes to the int oracle's
    2^k P; then microseconds per doubling at the PDBL_TIMED widths, ten
    launches of k = PDBL_K per timed run, beside the bound of that width
    (the function's least work per doubling)."""
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    for n in PDBL_CHECKED:
        Pn = tuple(c[:, :n] for c in P)
        for k in (1, 4, 8):
            want = ck.pdbl_plain(Pn, k)
            _same(f"pdbl k={k} n={n}", ck.pdbl(Pn, k), want)
            if cv.to_host(cv.PointVec(*(c[:, :4] for c in want))) != _doubled(host_p[: min(n, 4)], k):
                raise AssertionError(f"pdbl k={k} disagrees with the int oracle")
    out = {}
    for n in PDBL_TIMED:
        Pn = tuple(c[:, :n].contiguous() for c in P)
        ms = cuda_time(lambda: [ck.pdbl(Pn, PDBL_K) for _ in range(10)], 5, queued=True)
        b = bound(6 * FQ_BYTES * n, MIN_MULS_PDBL * PDBL_K * n, IMPL_MULS_PDBL * PDBL_K * n, sm_mhz)
        out[n] = {"us_per_double": ms * 1e3 / (10 * PDBL_K),
                  "bound_us_per_double": b["bound_ms"] * 1e3 / PDBL_K, "bound_by": b["bound_by"]}
    return out


def _padd_widths(P, Q, host_p, host_q, kind, sm_mhz) -> dict:
    """padd held to padd_plain at the PADD_CHECKED widths on lanes ordered
    edge cases first (P the identity, P == Q, P == -Q, Q the identity), the
    first eight lanes of each width to the int oracle; the path's shape
    (PADD_PATH_LANES lanes, ten launches per timed run); microseconds per
    launch at every PADD_TIMED width, ten launches queued per timed run,
    beside the bound of that width."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops import curve as cv

    n0 = P[0].shape[1]
    edge = [host_p.index(None)] + [int(np.flatnonzero(kind == k)[0]) for k in (1, 2, 3)]
    rest = sorted(set(range(n0)) - set(edge))
    widest = max(PADD_CHECKED + PADD_TIMED)
    order = ((edge + rest) * (widest // n0 + 1))[:widest]
    idx = torch.tensor(order, device=P[0].device)
    Pw, Qw = (tuple(c[:, idx].contiguous() for c in X) for X in (P, Q))
    oracle = [F.p_add(host_p[i], host_q[i]) for i in order[:8]]

    def cut(n):
        return (tuple(c[:, :n].contiguous() for c in X) for X in (Pw, Qw))

    for n in PADD_CHECKED:
        Pn, Qn = cut(n)
        want = ck.padd_plain(Pn, Qn)
        _same(f"padd n={n}", ck.padd(Pn, Qn), want)
        m = min(n, 8)
        if cv.to_host(cv.PointVec(*(c[:, :m] for c in want))) != oracle[:m]:
            raise AssertionError(f"padd at {n} lanes disagrees with the int oracle")
    n = PADD_PATH_LANES
    Pn, Qn = cut(n)
    path = {"lanes": n, "max_abs_err": _same(f"padd n={n}", ck.padd(Pn, Qn), ck.padd_plain(Pn, Qn)),
            "ms": cuda_time(lambda: [ck.padd(Pn, Qn) for _ in range(10)], 5, queued=True) / 10,
            "plain_ms": cuda_time(lambda: ck.padd_plain(Pn, Qn), 5), "library_ms": None,
            **bound(9 * FQ_BYTES * n, MIN_MULS_PADD * n, IMPL_MULS_PADD * n, sm_mhz)}
    by_width = {}
    for n in PADD_TIMED:
        Pn, Qn = cut(n)
        ten = lambda: [ck.padd(Pn, Qn) for _ in range(10)]  # noqa: E731
        b = bound(9 * FQ_BYTES * n, MIN_MULS_PADD * n, IMPL_MULS_PADD * n, sm_mhz)
        # the same ten launches not queued: the wrappers' dispatch shows
        # where it outlasts the kernel
        by_width[n] = {"us": cuda_time(ten, 7, queued=True) * 1e3 / 10,
                       "us_dispatch_bound": cuda_time(ten, 7) * 1e3 / 10,
                       "bound_us": b["bound_ms"] * 1e3, "bound_by": b["bound_by"]}
    return {"at_path_shape": path, "by_width": by_width}


def _column_oracle(M, meta, col: int):
    """The int oracle's sum of column col's live slots, decoded from M."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    m = int(meta[0, col])
    off, end = m & 7, min((m & 7) + (m >> 3), M.shape[1])
    acc = None
    for p in cv.to_host(cv.PointVec(*ck.slot_points(M[:, off:end, col], M.shape[0]))):
        acc = F.p_add(acc, p)
    return acc


def _bucket_sweep(M, meta, sm_mhz, rng):
    """bucket_masked on one input: the kernel at its split (bucket_split)
    equal to the twin at that split on every column, and at every split on
    the first TWIN_MAX_LANES / T columns (the twin's widest run that fits
    the card); eight columns against the int oracle; median times at every
    split; the bound of this input's live slots (each read once, one mixed
    add each for 18 lanes, a full add for 54).  -> (got, want, info)."""
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops.field import L

    lanes, padp, cols = M.shape
    T = ck.bucket_split(padp, cols)
    got = ck.bucket_masked(M, meta)
    want = ck.bucket_masked_plain(M, meta, T)
    _same(f"bucket_masked {lanes}x{padp}x{cols} T={T}", got, want)
    ms_by_split = {}
    for t in SPLITS:
        c = min(cols, TWIN_MAX_LANES // t)
        _same(f"bucket_masked {lanes}x{padp}x{cols} T={t}, first {c} columns",
              [g[:, :c] for g in ck.bucket_masked(M, meta, t)], ck.bucket_masked_plain(M[:, :, :c], meta[:, :c], t))
        ms_by_split[t] = cuda_time(lambda t=t: ck.bucket_masked(M, meta, t), 10)
    for col in rng.choice(cols, 8, replace=False):
        if cv.to_host(cv.PointVec(*(c[:, col : col + 1] for c in got)))[0] != _column_oracle(M, meta, int(col)):
            raise AssertionError(f"bucket_masked {lanes}x{padp}x{cols} disagrees with the int oracle")
    mn = meta[0].cpu().numpy()
    live = np.clip(np.minimum(mn >> 3, padp - (mn & 7)), 0, None)
    adds = int(live.sum())
    point_bytes, muls = (2 * FQ_BYTES, MIN_MULS_MADD) if lanes == L else (3 * FQ_BYTES, MIN_MULS_PADD)
    info = {"shape": [lanes, padp, cols], "split": T, "mean_len": float(live.mean()), "max_len": int(live.max()),
            "ms": cuda_time(lambda: ck.bucket_masked(M, meta), 10),
            "plain_ms": cuda_time(lambda: ck.bucket_masked_plain(M, meta, T), 1),
            "ms_by_split": ms_by_split,
            **bound(adds * point_bytes + cols * 4 + 3 * FQ_BYTES * cols, muls * adds, IMPL_MULS_PADD * adds,
                    sm_mhz)}
    return got, want, info


def _decider_fill(pp, rng, K: int):
    """The masked bucket kernel's input (M, meta) for the widest window group
    of K stacked n = 16384 decider MSMs over the URS with random scalars,
    built as msm.msm_many_flagged builds it (window-major digit rows)."""
    from halo_accumulation_tpu_torch.ops import msm as msm_mod
    from halo_accumulation_tpu_torch.ops.field import L

    lim = rng.integers(0, 1 << 15, (L, K, N), dtype=np.int64)
    lim[16] &= (1 << 14) - 1  # scalars below 2^254 < r
    lim[17] = 0
    c = msm_mod.window_size(N)
    digits = msm_mod._digits(torch.from_numpy(lim).to(pp.gs_x.device), c)
    W = digits.shape[0]
    rep = lambda xs: [x for x in xs for _ in range(K)]  # noqa: E731
    groups = msm_mod._expand_groups_sorted(rep(msm_mod.pinned_pads(N, c)), rep(msm_mod._beffs(c)))
    w0, w1, beff, pad = max(groups, key=lambda g: g[1] - g[0])
    M, meta, ok = msm_mod._sorted_payload(pp.gs_planes(N), digits.reshape(W * K, N)[w0:w1], pad, beff)
    if not bool(ok):
        raise AssertionError("the decider fill overflowed its pinned pad")
    return M, meta


def _fmul_timings(a, b, got) -> dict:
    """fmul at LANES by block size, microseconds a launch over ten queued
    launches: on the same a, b (hot in L2, as the ms column) and with each
    launch on its own pair (rolls of a, b: FMUL_ROTATE pairs, more than the
    L2 holds, so the inputs come from HBM); beside them torch.add of the
    same planes, which moves the same bytes with no arithmetic: the int64
    boundary's floor as this card reaches it."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    pairs = [(torch.roll(a, i, 1), torch.roll(b, i, 1)) for i in range(FMUL_ROTATE)]

    def us(fn):
        return cuda_time(fn, 7, queued=True) * 1e3 / 10

    by_threads = {}
    for t in FMUL_THREADS_TIMED:
        if not torch.equal(ck.fmul(a, b, t), got):
            raise AssertionError(f"fmul at {t} threads a block differs from {ck.FMUL_THREADS}")
        by_threads[t] = {"us": us(lambda t=t: [ck.fmul(a, b, t) for _ in range(10)]),
                         "us_l2_rotated": us(lambda t=t: [ck.fmul(x, y, t) for x, y in pairs])}
    return {"threads": ck.FMUL_THREADS, "by_threads": by_threads,
            "plane_add_us": us(lambda: [torch.add(a, b) for _ in range(10)]),
            "plane_add_us_l2_rotated": us(lambda: [torch.add(x, y) for x, y in pairs])}


def _accum_sweep(rows, src) -> dict:
    """bucket_accum at every split of SPLITS, each held to its twin at
    that split on every column: median ms by T."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    lanes, (pad, cols) = rows.shape[1], src.shape
    out = {}
    for t in SPLITS:
        _same(f"bucket_accum {lanes}x{pad}x{cols} T={t}", ck.bucket_accum(rows, src, t),
              ck.bucket_accum_plain(rows, src, t))
        out[t] = cuda_time(lambda t=t: ck.bucket_accum(rows, src, t), 10)
    return out


def _accum_top_window(rows, rng) -> dict:
    """bucket_accum at the folded top window's shape (ACCUM_TOP_SHAPE: the
    n = 16384 MSM's last window, 128 columns x 384 slots folded 8 ways),
    rows of the same table: the split chosen there and the sweep."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    pad, cols = ACCUM_TOP_SHAPE
    src = torch.from_numpy(rng.integers(0, rows.shape[0], (pad, cols))).to(rows.device)
    return {"shape": [rows.shape[1], pad, cols], "split": ck.accum_split(pad, cols),
            "ms_by_split": _accum_sweep(rows, src)}


def phase_kernels(dev, pp, sm_mhz):
    """Every kernel against its twin at the main path's shapes."""
    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops import msm as msm_mod
    from halo_accumulation_tpu_torch.ops.field import FQ, L

    rng = np.random.default_rng(SEED)
    res = {}

    def record(name, got, want, ms, plain_ms, bnd, field=None, **extra):
        res[name] = {"max_abs_err": _same(name, got, want, field), "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, **bnd, **extra}

    # fmul: random lazy limbs (value < 2^257), timed over ten launches
    # queued; then every pair of the edge lanes
    lim = rng.integers(0, 1 << 15, size=(2, L, LANES), dtype=np.int64)
    lim[:, 17] &= 3
    a, b = (torch.from_numpy(x).to(dev) for x in lim)
    got = ck.fmul(a, b)
    want = ck.fmul_plain(a, b)
    record("fmul", [got], [want], cuda_time(lambda: [ck.fmul(a, b) for _ in range(10)], 7, queued=True) / 10,
           cuda_time(lambda: ck.fmul_plain(a, b), 5),
           bound(3 * FQ_BYTES * LANES, MIN_MULS_FMUL * LANES, IMPL_MULS_FMUL * LANES, sm_mhz),
           **_fmul_timings(a, b, got))
    sample = rng.choice(LANES, 64, replace=False)
    ai = _raw_ints(a[:, sample])
    bi = _raw_ints(b[:, sample])
    if FQ.to_ints(got[:, sample]) != [x * y % F.Q for x, y in zip(ai, bi)]:
        raise AssertionError("fmul disagrees with the int oracle")
    edges = fmul_edge_limbs()
    ea, eb = (torch.tensor([e for e in edges for _ in edges], dtype=torch.int64).T.contiguous(),
              torch.tensor([e for _ in edges for e in edges], dtype=torch.int64).T.contiguous())
    got = ck.fmul(ea.to(dev), eb.to(dev))
    _same("fmul edge lanes", [got], [ck.fmul_plain(ea, eb).to(dev)])
    if FQ.to_ints(got) != [x * y % F.Q for x, y in zip(_raw_ints(ea), _raw_ints(eb))]:
        raise AssertionError("fmul disagrees with the int oracle on the edge lanes")
    res["fmul"]["edge_lanes"] = ea.shape[1]

    # padd / pdbl: identity lanes, P == Q, P == -Q, lazy projective limbs
    base, P, Q, host_p, host_q, kind = _point_pairs(rng, dev)
    got = ck.padd(tuple(P), tuple(Q))
    want = ck.padd_plain(tuple(P), tuple(Q))
    record("padd", got, want, cuda_time(lambda: [ck.padd(tuple(P), tuple(Q)) for _ in range(10)], 7,
                                        queued=True) / 10,
           cuda_time(lambda: ck.padd_plain(tuple(P), tuple(Q)), 5),
           bound(9 * FQ_BYTES * LANES, MIN_MULS_PADD * LANES, IMPL_MULS_PADD * LANES, sm_mhz))
    if cv.to_host(cv.PointVec(*(c[:, sample] for c in got))) != [
        F.p_add(host_p[i], host_q[i]) for i in sample
    ]:
        raise AssertionError("padd disagrees with the int oracle")
    res["padd"].update(_padd_widths(tuple(P), tuple(Q), host_p, host_q, kind, sm_mhz))
    got = ck.pdbl(tuple(P))
    _same("pdbl", got, ck.pdbl_plain(tuple(P)))
    if cv.to_host(cv.PointVec(*(c[:, sample] for c in got))) != [
        F.p_add(host_p[i], host_p[i]) for i in sample
    ]:
        raise AssertionError("pdbl disagrees with the int oracle")
    # the pdbl row: the shape of decide_many's Horner combine
    n = PDBL_PATH_LANES
    Pn = tuple(c[:, :n].contiguous() for c in P)
    record("pdbl", ck.pdbl(Pn, PDBL_K), ck.pdbl_plain(Pn, PDBL_K),
           cuda_time(lambda: [ck.pdbl(Pn, PDBL_K) for _ in range(10)], 7, queued=True) / 10,
           cuda_time(lambda: ck.pdbl_plain(Pn, PDBL_K), 5),
           bound(6 * FQ_BYTES * n, MIN_MULS_PDBL * PDBL_K * n, IMPL_MULS_PDBL * PDBL_K * n, sm_mhz),
           lanes=n, k=PDBL_K, by_width=_pdbl_widths(tuple(P), host_p, sm_mhz))

    # bucket_masked at the n = 16384 decider's main group: lanes 18 (packed
    # affine), pad' 136, 31 windows x 256 buckets, uniform fill; every slot
    # holds a point, so slots outside [off, off + len) are foreign and must
    # be ignored
    pts = [p for p in base if p is not None]
    xs = FQ.from_ints([p[0] for p in pts], dev)
    ys = FQ.from_ints([p[1] for p in pts], dev)
    planes = msm_mod.planes_from_affine(xs, ys)  # (18, 64)
    padp, cols = BUCKET_SHAPE
    M = planes[:, torch.from_numpy(rng.integers(0, len(pts), (padp, cols))).to(dev)]  # (18, padp, cols)
    off = rng.integers(0, 8, cols)
    ln = rng.integers(0, padp - 7, cols)  # len <= pad = padp - 8
    ln[rng.random(cols) < 0.05] = 0  # dead columns
    meta = torch.from_numpy((off | (ln << 3)).reshape(1, cols)).to(dev)
    got, want, info = _bucket_sweep(M, meta, sm_mhz, rng)
    by_fill = {"uniform": dict(info)}
    record("bucket_masked", got, want, info.pop("ms"), info.pop("plain_ms"),
           {k: info.pop(k) for k in ("bound_ms", "bound_by", "bytes", "muls32", "impl_muls32")}, **info,
           by_fill=by_fill)
    del M
    # the deciders' real fills: digits of random scalars over the URS through
    # the sort-payload MSM's own gather (verify_chain's final decider: one
    # MSM; decide_many: K = 10 stacked)
    for name, K in (("verify_chain_decider", 1), ("decide_many_decider", 10)):
        Mr, metar = _decider_fill(pp, rng, K)
        by_fill[name] = _bucket_sweep(Mr, metar, sm_mhz, rng)[2]
        del Mr
    # lanes 54 (projective, lazy limbs) at the prover's dual-route round
    # shape (n = 8192 per route: pad' 104, 2 x 31 windows x 256 buckets)
    padp2, cols2 = PROVER_ROUND_SHAPE
    src2 = torch.from_numpy(rng.integers(0, LANES, (padp2, cols2))).to(dev)
    M2 = torch.cat([c[:, src2] for c in P])  # (54, padp2, cols2)
    off2 = rng.integers(0, 8, cols2)
    ln2 = rng.integers(0, padp2 - 7, cols2)
    ln2[rng.random(cols2) < 0.05] = 0
    meta2 = torch.from_numpy((off2 | (ln2 << 3)).reshape(1, cols2)).to(dev)
    by_fill["prover_round_54"] = _bucket_sweep(M2, meta2, sm_mhz, rng)[2]
    del M2

    # bucket_accum at the n = 16384 rowperm main group: URS rows, affine (40
    # lanes, the commit / decider MSMs) and projective with lazy limbs (64
    # lanes, the prover's rounds); about 5 % of the slots hold the sentinel
    pad, cols = ROWPERM_SHAPE
    srcn = rng.integers(0, N, (pad, cols))
    srcn[rng.random((pad, cols)) < 0.05] = N
    src = torch.from_numpy(srcn).to(dev)
    need = sorted(set(srcn[:, :8].reshape(-1).tolist()) - {N})
    host = dict(zip(need, zip(FQ.to_ints(pp.gs_x[:, need]), FQ.to_ints(pp.gs_y[:, need]))))
    host[N] = None
    gs = pp.gs_points(N)
    tables = {40: pp.gs_rows(N), 64: msm_mod.rows_from_points(_scaled(gs, _rand_lam(rng, N, dev)))}
    # the function reads each of the N points once (64 bytes affine, 96
    # projective) and a 4-byte row index per slot, and writes a projective
    # point per column; each non-sentinel slot is one add (mixed for affine
    # rows), while this kernel adds every slot, sentinels included
    live = int((srcn != N).sum())
    for lanes, rows in tables.items():
        T = ck.accum_split(pad, cols)
        got = ck.bucket_accum(rows, src)
        want = ck.bucket_accum_plain(rows, src, T)
        point_bytes, muls = (2 * FQ_BYTES, MIN_MULS_MADD) if lanes == ck.AFFINE_LANES else (3 * FQ_BYTES, MIN_MULS_PADD)
        record(f"bucket_accum_{lanes}", got, want, cuda_time(lambda: ck.bucket_accum(rows, src), 10),
               cuda_time(lambda: ck.bucket_accum_plain(rows, src, T), 2),
               bound(N * point_bytes + 4 * pad * cols + 3 * FQ_BYTES * cols, muls * live,
                     IMPL_MULS_PADD * pad * cols, sm_mhz),
               shape=[lanes, pad, cols], split=T, ms_by_split=_accum_sweep(rows, src),
               top_window=_accum_top_window(rows, rng))
        for col in range(8):
            acc = None
            for p in range(pad):
                acc = F.p_add(acc, host[int(srcn[p, col])])
            if cv.to_host(cv.PointVec(*(c[:, col : col + 1] for c in got)))[0] != acc:
                raise AssertionError(f"bucket_accum ({lanes} lanes) disagrees with the int oracle")
    _finv_rows(dev, rng, sm_mhz, record)
    _rho_rows(dev, rng, sm_mhz, record)
    emit({"phase": "kernels", "lanes": LANES, **res})
    # the kernels line reports the 64-lane shape (the prover's rounds, most
    # of the launches) and carries both
    res["bucket_accum"] = {**res["bucket_accum_64"], "by_lanes": {k: res[f"bucket_accum_{k}"] for k in tables}}
    # and finv's Fq row (to_affine), with both fields' rows
    res["finv"]["by_field"] = {"Fq": dict(res["finv"]), "Fr": res["finv_fr"]}
    return res


def finv_edge_limbs(p: int) -> list[list[int]]:
    """finv's edge lanes mod p as 18 limbs each: 0, 1, p - 1, 2^254 and
    (p + 1) / 2 canonical; then lazy limbs of values at or above p up to the
    boundary's 2^257: p (a lazy zero), p + 1, 2p - 1, 2^255 - 1 and 2^257 - 1
    (clean limbs, limb 17 holding the bits from 255), and every limb at
    0x8008 (the nearly clean bound) with limb 17 at 2."""
    def clean(v):
        return [(v >> (15 * i)) & 0x7FFF for i in range(17)] + [v >> 255]

    vals = (0, 1, p - 1, 1 << 254, (p + 1) // 2, p, p + 1, 2 * p - 1, (1 << 255) - 1, (1 << 257) - 1)
    return [clean(v) for v in vals] + [[0x8008] * 17 + [2]]


def _finv_rows(dev, rng, sm_mhz, record) -> None:
    """finv held to its twin (FQ or FR pow_const(a, p - 2)) at the
    FINV_CHECKED widths of both fields, the edge lanes (finv_edge_limbs)
    first, and to the int oracle's inverses; every width timed over ten
    queued launches (ms_by_width), 1,024 and 65,536 lanes also one launch
    at a time (wide_ms); the path's shape (FINV_PATH_LANES) beside
    the bound of an inversion's least work.  One row per field: finv (Fq,
    to_affine) and finv_fr (FR.inv of each round's challenge)."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops.field import FQ, FR, limb_array_to_ints

    for name, f in (("finv", FQ), ("finv_fr", FR)):
        widest = max(FINV_CHECKED)
        edges = finv_edge_limbs(f.p)
        rand = f.from_ints([int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(64 - len(edges))])
        lanes = torch.cat([torch.tensor(edges, dtype=torch.int64).T, rand], 1)
        vals = limb_array_to_ints(lanes.numpy())
        a = lanes.to(dev)[:, torch.arange(widest, device=dev) % len(vals)].contiguous()
        by_width = {}
        for n in FINV_CHECKED:
            an = a[:, :n].contiguous()
            got = ck.finv(an, f)
            _same(f"{name} n={n}", [got], [ck.finv_plain(an, f)], f)
            m = min(n, len(vals))
            if f.to_ints(got[:, :m]) != [pow(v % f.p, f.p - 2, f.p) for v in vals[:m]]:
                raise AssertionError(f"{name} at {n} lanes disagrees with the int oracle")
            by_width[n] = cuda_time(lambda: [ck.finv(an, f) for _ in range(10)], 7, queued=True) / 10
        n = FINV_PATH_LANES
        an = a[:, len(edges) : len(edges) + n].contiguous()  # random lanes
        sq, mu = finv_least_chain(f.p)
        record(name, [ck.finv(an, f)], [ck.finv_plain(an, f)], by_width[n],
               cuda_time(lambda: ck.finv_plain(an, f), 3),
               bound(2 * FQ_BYTES * n, finv_least_ops(f.p) * n, FINV_IMPL_OPS32 * n, sm_mhz),
               field=f, lanes=n, edge_lanes=len(edges), ms_by_width=by_width,
               least={"divstep_ops": FINV_DIVSTEP_OPS32,
                      "fermat_chain": {"squarings": sq, "multiplies": mu,
                                       "ops": sq * MIN_MULS_SQR + mu * MIN_MULS_FMUL}},
               impl={"batches": FINV_BATCHES, "divsteps": FINV_BATCHES * FINV_BATCH, "ops": FINV_IMPL_OPS32},
               wide_ms={w: cuda_time(lambda aw=a[:, :w].contiguous(): ck.finv(aw, f), 5) for w in (1024, widest)},
               note="divsteps, a lane a thread: at the path's few lanes one warp's dependent chain of "
                    "20 batches; its latency, not the rate, is what the card cannot beat")


def rho_cases(rng) -> list:
    """rho_round's (xi, L, R) cases: RHO_RANDOM random triples, then L, R
    or both the identity, L = -R with xi = 0, and the flag's boundary y =
    (q - 1) / 2 (no flag) and (q + 1) / 2 (flagged) on either side with xi
    = r - 1 and 8 (a boundary point need not lie on the curve: the message
    takes only x and the flag)."""
    from halo_accumulation_tpu_torch import fields as F

    half = (F.Q - 1) // 2
    pts = _base_points(rng, 2 * RHO_RANDOM)
    cases = [(int.from_bytes(rng.bytes(40), "little") % F.R, pts[2 * i], pts[2 * i + 1]) for i in range(RHO_RANDOM)]
    return cases + [(5, None, pts[0]), (6, pts[1], None), (7, None, None), (0, pts[2], F.p_neg(pts[2])),
                    (F.R - 1, (pts[3][0], half), (pts[4][0], half + 1)),
                    (8, (pts[5][0], half + 1), (pts[6][0], half))]


def _rho_rows(dev, rng, sm_mhz, record) -> None:
    """rho_round held to its twin (ops/keccak.rho_round on the same card
    tensors) on the rho_cases, and the kernel's challenge to the host
    transcript's on every case; timed over ten queued launches beside its
    bound."""
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
    from halo_accumulation_tpu_torch.ops.field import FQ, FR
    from halo_accumulation_tpu_torch.utils import serialize as ser
    from halo_accumulation_tpu_torch.utils import transcript as tr

    cases = rho_cases(rng)
    xs = FQ.from_ints([0 if P is None else P[0] for _, P, Q in cases for P in (P, Q)], dev)
    ys = FQ.from_ints([0 if P is None else P[1] for _, P, Q in cases for P in (P, Q)], dev)
    inf = torch.tensor([P is None for _, P, Q in cases for P in (P, Q)], device=dev)
    xis = FR.from_ints([c[0] for c in cases], dev)
    outs, wants = [], []
    for i, (xi, P, Q) in enumerate(cases):
        args = (xis[:, i], xs[:, 2 * i], ys[:, 2 * i], inf[2 * i], xs[:, 2 * i + 1], ys[:, 2 * i + 1], inf[2 * i + 1])
        got = ck.rho_round(*args)
        _same(f"rho_round case {i}", [got[:, None]], [ck.rho_round_plain(*args)[:, None]], FR)
        outs.append(got)
        wants.append(tr.rho_0(ser.ser_scalar(xi), ser.ser_point(P), ser.ser_point(Q)))
    if FR.to_ints(torch.stack(outs, 1)) != wants:
        raise AssertionError("rho_round disagrees with the host transcript")
    args = (xis[:, 0], xs[:, 0], ys[:, 0], inf[0], xs[:, 1], ys[:, 1], inf[1])
    record("rho_round", [ck.rho_round(*args)[:, None]], [ck.rho_round_plain(*args)[:, None]],
           cuda_time(lambda: [ck.rho_round(*args) for _ in range(10)], 7, queued=True) / 10,
           cuda_time(lambda: ck.rho_round_plain(*args), 3),
           bound(RHO_BYTES, KECCAK_OPS32, KECCAK_IMPL_OPS32, sm_mhz), field=FR, cases=len(cases),
           note="one warp, a lane a thread: the launch and the rounds' dependent shuffles, not the "
                "rate, are what the card cannot beat")


def _raw_ints(t):
    from halo_accumulation_tpu_torch.ops.field import limb_array_to_ints

    return limb_array_to_ints(t.cpu().numpy())


@contextlib.contextmanager
def safe_rebuilds():
    """A list that collects open_'s _safe rebuilds in the block."""
    from halo_accumulation_tpu_torch import pcdl

    calls, fn = [], pcdl.open_

    def spy(*args, **kwargs):
        if kwargs.get("_safe"):
            calls.append(kwargs)
        return fn(*args, **kwargs)

    pcdl.open_ = spy
    try:
        yield calls
    finally:
        pcdl.open_ = fn


# the prove phase's runs: (path, MSM setting, HALO_TPU_OPEN_DEVICE, kernels it
# must launch); rowperm opens on the host transcript whatever the switch says
PROVES = (("prove_sortrows", "sortrows", "1", MUST_LAUNCH["sortrows"] | OPEN_DEVICE_ALSO),
          ("prove_sortrows_host_open", "sortrows", "0", MUST_LAUNCH["sortrows"]),
          ("prove_rowperm", "rowperm", "1", MUST_LAUNCH["rowperm"]))


def phase_prove(pp, smi, launches, widths):
    """build_chain from default_rng(7) under each of PROVES, held to the
    committed chain's first step records byte for byte; no _safe rebuild."""
    from halo_accumulation_tpu_torch import chain

    raw = open(CHAIN, "rb").read()
    off = 16 + (8 if raw[:8] == chain.CHAIN_MAGIC else 0)  # d, k (and the tag) come first
    out = {}
    for path, impl, open_device, must in PROVES:
        built = {}
        with env("HALO_TPU_MSM_IMPL", impl), env("HALO_TPU_OPEN_DEVICE", open_device), safe_rebuilds() as rebuilds:
            s = counted(path, must,
                        lambda: built.update(c=chain.build_chain(np.random.default_rng(7), N, PROVE_STEPS, pp)),
                        launches, widths)
        if rebuilds:
            raise AssertionError(f"{path}: open_ took its _safe rebuild {len(rebuilds)} times")
        d, qss, accs = built["c"]
        pos = off
        for step, rec in enumerate(chain.step_records(qss, accs)):
            if raw[pos : pos + len(rec)] != rec:
                raise AssertionError(f"{path}: step {step} differs from {os.path.basename(CHAIN)}")
            pos += len(rec)
        out[path] = {"msm": impl, "HALO_TPU_OPEN_DEVICE": open_device, "wall_s": s,
                     "bytes_matched": pos - off, "safe_rebuilds": 0, "launches": launches[path]}
    emit({"phase": "prove", "n": N, "steps": PROVE_STEPS, "reduced": f"depth {PROVE_STEPS} of the file's 10 steps",
          "card": smi, "rng": "numpy default_rng(7)", "vs": os.path.basename(CHAIN), **out})
    return out


def _runtime_events(prof) -> tuple[list, Counter]:
    """A torch.profiler trace's device events (start us, end us, name) in
    time order, and its host calls that launch device work (cudaLaunchKernel,
    cudaGraphLaunch, ...) counted by name.  Read from the raw kineto events:
    prof.events() builds a tree over every host op, which takes minutes for
    a prover step's million of them."""
    from torch.autograd import DeviceType

    dev, launches = [], Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()))
        elif e.name().startswith("cu") and ("Launch" in e.name() or "Memcpy" in e.name()):
            launches[e.name()] += 1
    return sorted(dev), launches


def _busy_us(dev) -> float:
    """The union of the device intervals, in us."""
    busy, hi = 0.0, float("-inf")
    for start, end, _ in dev:
        busy += max(0.0, end - max(start, hi))
        hi = max(hi, end)
    return busy


@contextlib.contextmanager
def strict_bodies(names: list):
    """Every graphed body in the block runs eagerly on card inputs under
    torch.cuda.set_sync_debug_mode("error") (after one warm run that makes
    the cached device constants): a host sync inside a body raises.  names
    collects the bodies run."""
    from halo_accumulation_tpu_torch import runtime

    graphed = runtime.graphed

    def strict(name, shape_key, body, args, device, holds=()):
        args = [a.to(device) for a in args]
        body(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = body(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        names.append(name)
        return out

    runtime.graphed = strict
    try:
        yield names
    finally:
        runtime.graphed = graphed


def phase_open_copies(pp, smi) -> dict:
    """One device-transcript open at n = N (a hiding opening of a random
    polynomial of degree N - 1, under the defaults), its graph captured
    already, with torch.profiler and torch.cuda.set_sync_debug_mode("warn")
    around _open_device: its device-to-host copies ("Memcpy DtoH" events;
    expected one, the proof), its host-to-device copies ("Memcpy HtoD";
    expected one, H', xi_0 and z into the graph's static input), its graph
    replays (cudaGraphLaunch; expected one) and the synchronizing calls by
    the source line that made them (those two copies).  Then the same open
    with its body run eagerly under set_sync_debug_mode("error"): nothing
    inside the body may sync.  Both openings must check."""
    import collections
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from halo_accumulation_tpu_torch import fields as F
    from halo_accumulation_tpu_torch import pcdl
    from halo_accumulation_tpu_torch.ops.field import FR

    rng = np.random.default_rng(SEED + 2)
    coeffs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(N)]
    z, w = (int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2))
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R
    cd = FR.from_ints(coeffs, pp.device)
    C = pcdl.commit(cd, N - 1, w, pp)
    seen = {}
    inner = pcdl._open_device

    def traced(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t = time.perf_counter()
                try:
                    res = inner(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                seen["wall_s"] = time.perf_counter() - t
        dev, launches = _runtime_events(prof)
        seen["memcpy_dtoh"] = sum("DtoH" in name for _, _, name in dev)
        seen["memcpy_htod"] = sum("HtoD" in name for _, _, name in dev)
        seen["graph_launches"] = launches["cudaGraphLaunch"]
        seen["host_launches"] = dict(launches)
        syncs = [w for w in rec if "called a synchronizing CUDA operation" in str(w.message)]
        seen["sync_warnings"] = len(syncs)
        seen["sync_warnings_by_line"] = dict(collections.Counter(
            f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in syncs).most_common())
        return res

    with safe_rebuilds() as rebuilds:
        pcdl._open_device = traced
        try:
            pi = pcdl.open_(np.random.default_rng(3), cd, C, N - 1, z, w, pp, v=v)
        finally:
            pcdl._open_device = inner
        pcdl.check(C, N - 1, z, v, pi, pp)
        with strict_bodies([]) as names:
            pi2 = pcdl.open_(np.random.default_rng(3), cd, C, N - 1, z, w, pp, v=v)
    if pi2.serialize() != pi.serialize():
        raise AssertionError("the device open's replay and its eager body wrote different proofs")
    out = {"phase": "open_copies", "n": N, "card": smi, **seen, "bodies_sync_free": names,
           "safe_rebuilds": len(rebuilds)}
    emit(out)
    if (seen.get("memcpy_dtoh"), seen.get("memcpy_htod"), seen.get("graph_launches")) != (1, 1, 1) or rebuilds \
            or names != ["open"]:
        raise AssertionError(f"device open: {seen.get('memcpy_dtoh')} device-to-host copies, "
                             f"{seen.get('memcpy_htod')} host-to-device copies, {seen.get('graph_launches')} graph "
                             f"replays (expected 1, 1, 1), {len(rebuilds)} _safe rebuilds, bodies {names}")
    return out


def _expect_reject(fn, msg: str) -> None:
    try:
        fn()
    except ValueError as e:
        if str(e) != msg:
            raise AssertionError(f"rejected with {str(e)!r}, expected {msg!r}") from e
        return
    raise AssertionError(f"tampered input accepted, expected {msg!r}")


def _tampered(d, qss, accs, pp):
    """[(expected text, call)]: first two copies of the whole chain, the
    shape of the good runs before them, so each replays their verdict
    graph (the stale-input check: a replay that read the good chain would
    accept): c of step 4's fresh claim, which only its row equation reads,
    and v of the first accumulator, which the first decider's row reads.
    Then two tampered chains (v of the last step, v of the first decider's
    claim), then one field each of a one-step prefix.  Two cases tamper
    the verifier's key instead, as a proof that does not open under it: G0
    and G1 swapped reach only the U_0 rows, G2 and G3 swapped only the
    final decider's deferred MSM.  The texts are the JAX package's
    (REJECT_TEXTS)."""
    import dataclasses

    from halo_accumulation_tpu_torch import chain
    from halo_accumulation_tpu_torch import fields as F

    def fast(qs, acs, D=d, key=pp):
        return lambda: chain.verify_chain_fast(D, qs, acs, key)

    def bumped(a):
        return dataclasses.replace(a, v=(a.v + 1) % F.R)

    a0, q0 = accs[0], qss[0][0]
    short = dataclasses.replace(q0, pi=dataclasses.replace(q0.pi, Ls=q0.pi.Ls[:-1], Rs=q0.pi.Rs[:-1]))
    q4 = qss[4][1]
    q4_c = dataclasses.replace(q4, pi=dataclasses.replace(q4.pi, c=(q4.pi.c + 1) % F.R))
    T = REJECT_TEXTS
    return [
        (T["row"].format(b=8), fast(qss[:4] + [[qss[4][0], q4_c]] + qss[5:], accs)),
        (T["row"].format(b=0), lambda: chain.verify_chain_slow([bumped(a0)] + accs[1:], pp)),
        (T["v"].format(k=len(accs) - 1), fast(qss, accs[:-1] + [bumped(accs[-1])])),
        (T["row"].format(b=0), lambda: chain.verify_chain_slow([bumped(a0), accs[1]], pp)),
        (T["c_bar"].format(k=0), fast(qss[:1], [dataclasses.replace(a0, C_bar=accs[1].C_bar)])),
        (T["z"].format(k=0), fast(qss[:1], [dataclasses.replace(a0, z=(a0.z + 1) % F.R)])),
        (T["d"].format(k=0), fast(qss[:1], accs[:1], D=d + 1)),
        (T["length"], fast([[short] + qss[0][1:]], accs[:1])),
        (T["u0"].format(b=0), fast(qss[:1], accs[:1], key=_swapped(pp, 0, 1))),
        (T["u"], fast(qss[:1], accs[:1], key=_swapped(pp, 2, 3))),
    ]


STAGED_COMMIT_N = (16384, 65536)  # widths of the all-equal commits the staged phase makes
STAGED_SETTINGS = ("sortrows", "rowperm", "staged")


def _measured_calls():
    """A list that collects msm._msm_measured's point counts in the block."""
    from halo_accumulation_tpu_torch.ops import msm

    calls, fn = [], msm._msm_measured

    def spy(points, scalars, c=None):
        calls.append(points.x.shape[1])
        return fn(points, scalars, c)

    msm._msm_measured = spy
    return calls, lambda: setattr(msm, "_msm_measured", fn)


def _equal_commits(dev, launches, widths) -> dict:
    """At each of STAGED_COMMIT_N, the commitment to n equal coefficients
    under every setting: one _msm_measured call (the pinned pass overflows),
    the point native.msm gives, seconds and peak reserved memory."""
    from halo_accumulation_tpu_torch import native, pcdl
    from halo_accumulation_tpu_torch import pp as pp_mod
    from halo_accumulation_tpu_torch.ops.field import FR

    t = time.perf_counter()
    pp_mod.get_pp(max(STAGED_COMMIT_N), dev)
    torch.cuda.synchronize()
    out = {"urs_gen_s": time.perf_counter() - t}
    k = int.from_bytes(np.random.default_rng(SEED).bytes(40), "little") % (1 << 254)
    for n in STAGED_COMMIT_N:
        urs = pp_mod.get_pp(n, dev)
        coeffs = FR.from_int(k, (n,), dev).contiguous()
        t = time.perf_counter()
        want = native.msm([k] * n, urs.gs_host(n))
        out[f"native_msm_s_{n}"] = time.perf_counter() - t
        for impl in STAGED_SETTINGS:
            got = {}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_reserved()
            calls, restore = _measured_calls()
            try:
                with env("HALO_TPU_MSM_IMPL", impl):
                    s = counted(f"commit_equal_{n}_{impl}", MUST_LAUNCH["staged"],
                                lambda: got.update(C=pcdl.commit(coeffs, n - 1, None, urs)), launches, widths)
            finally:
                restore()
            if got["C"] != want:
                raise AssertionError(f"all-equal commit at n = {n} under {impl} differs from native.msm")
            if calls != [n]:
                raise AssertionError(f"all-equal commit at n = {n} under {impl}: _msm_measured calls {calls}")
            out[f"n{n}_{impl}"] = {"s": s, "reserved_before_bytes": base,
                                   "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                                   "launches": launches[f"commit_equal_{n}_{impl}"]}
    return out


def _sharded(pp, mesh, launches, widths) -> dict:
    """msm_sharded on the one-rank NCCL mesh against msm at N points, and
    check_device(mesh=) against check_device on chain_16384_10.bin's first
    claim and on a copy with U off by one generator."""
    import dataclasses

    import torch.distributed as dist

    from halo_accumulation_tpu_torch import chain, fields as F, pcdl
    from halo_accumulation_tpu_torch.ops import curve as cv, msm
    from halo_accumulation_tpu_torch.ops.field import FR
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    rng = np.random.default_rng(SEED)
    s = FR.from_ints([int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(N)], pp.device)
    P = pp.gs_points(N)
    ref = msm.msm(P, s)
    got = {}
    sec = counted("msm_sharded", MUST_LAUNCH["staged"],
                  lambda: got.update(R=sh.msm_sharded(sh.shard_points(P, mesh), s, mesh)), launches, widths)
    if not bool(cv.peq(got["R"], ref)):
        raise AssertionError("msm_sharded on one rank differs from msm")
    _, qss, _ = chain.load_chain(CHAIN)
    q = qss[0][0]
    bad = dataclasses.replace(q.pi, U=F.p_add(q.pi.U, pp.gs_host(1)[0]))
    plain = [bool(pcdl.check_device(q.C, q.d, q.z, q.v, pi, pp)) for pi in (q.pi, bad)]
    verdicts = []
    check_s = counted("check_device_mesh", MUST_LAUNCH["staged"] | VERIFY_ALSO,
                      lambda: verdicts.extend(bool(pcdl.check_device(q.C, q.d, q.z, q.v, pi, pp, mesh=mesh))
                                              for pi in (q.pi, bad)), launches, widths)
    if verdicts != plain or plain != [True, False]:
        raise AssertionError(f"check_device(mesh=) verdicts {verdicts}, without a mesh {plain}")
    return {"backend": dist.get_backend(), "world_size": dist.get_world_size(), "n": N,
            "msm_sharded_s": sec, "check_device_mesh_s": check_s, "verdicts": verdicts}


def _staged_profiles(pp, mesh) -> dict:
    """One warm run of each staged path under torch.profiler (_profiled):
    a prover step, verify_chain and decide_many on chain_16384_10.bin, and
    the all-equal commit at N; then msm_sharded under profiling.trace with
    HALO_TPU_TRACE set, whose Chrome trace must hold device events."""
    from halo_accumulation_tpu_torch import chain, fields as F, pcdl, profiling
    from halo_accumulation_tpu_torch.ops.field import FR
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    d, qss, accs = chain.load_chain(CHAIN)
    k = int.from_bytes(np.random.default_rng(SEED).bytes(40), "little") % (1 << 254)
    coeffs = FR.from_int(k, (N,), pp.device).contiguous()
    paths = {"prove_staged_1step": lambda: chain.build_chain(np.random.default_rng(7), N, 1, pp),
             "verify_chain_staged": lambda: chain.verify_chain_fast(d, qss, accs, pp),
             "decide_many_staged": lambda: chain.verify_chain_slow(accs, pp),
             f"commit_equal_{N}_staged": lambda: pcdl.commit(coeffs, N - 1, None, pp)}
    out = {}
    with env("HALO_TPU_MSM_IMPL", "staged"):
        for path, fn in paths.items():
            fn()
            torch.cuda.reset_peak_memory_stats()
            out[path] = {**_profiled(fn), "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    rng = np.random.default_rng(SEED + 1)
    s = FR.from_ints([int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(N)], pp.device)
    tdir = os.path.join(PROFILE_DIR, "trace")
    shard = sh.shard_points(pp.gs_points(N), mesh)
    sh.msm_sharded(shard, s, mesh)
    out["msm_sharded"] = _profiled(lambda: sh.msm_sharded(shard, s, mesh))
    with env("HALO_TPU_TRACE", tdir), profiling.trace("msm_sharded"):
        sh.msm_sharded(shard, s, mesh)
        torch.cuda.synchronize()
    with open(os.path.join(tdir, "msm_sharded.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("profiling.trace wrote no device kernel events")
    out["trace_file"] = {"path": os.path.relpath(os.path.join(tdir, "msm_sharded.json"), REPO), "kernel_events": kernels}
    return out


def phase_staged(pp, smi, mesh, launches, widths) -> None:
    """The staged backstop and the sharded MSM on the card (see the module
    docstring, phase 5), the latter on mesh, a one-rank NCCL mesh; padd's
    and pdbl's launches by width on each of these paths."""
    from halo_accumulation_tpu_torch import chain

    raw = open(CHAIN, "rb").read()
    off = 16 + (8 if raw[:8] == chain.CHAIN_MAGIC else 0)
    built = {}
    with env("HALO_TPU_MSM_IMPL", "staged"), safe_rebuilds() as rebuilds:
        prove_s = counted("prove_staged", MUST_LAUNCH["staged"],
                          lambda: built.update(c=chain.build_chain(np.random.default_rng(7), N, 1, pp)),
                          launches, widths)
        d, qss, accs = built["c"]
        rec = b"".join(chain.step_records(qss, accs))
        if raw[off : off + len(rec)] != rec:
            raise AssertionError(f"prove_staged: step 0 differs from {os.path.basename(CHAIN)}")
        verify_s = counted("verify_chain_staged_built", MUST_LAUNCH["staged"] | VERIFY_ALSO,
                           lambda: chain.verify_chain_fast(d, qss, accs, pp), launches, widths)
        decide_s = counted("decide_many_staged_built", MUST_LAUNCH["staged"] | VERIFY_ALSO,
                           lambda: chain.verify_chain_slow(accs, pp), launches, widths)
    if rebuilds:
        raise AssertionError(f"prove_staged: open_ took its _safe rebuild {len(rebuilds)} times")
    out = {"prove_staged": {"wall_s": prove_s, "bytes_matched": len(rec), "safe_rebuilds": 0,
                            "verify_chain_s": verify_s, "decide_many_s": decide_s, "accepted": True}}
    out["equal_commits"] = _equal_commits(pp.device, launches, widths)
    out["sharded"] = _sharded(pp, mesh, launches, widths)
    out["profiled"] = _staged_profiles(pp, mesh)
    new = ["prove_staged", "verify_chain_staged_built", "decide_many_staged_built", "msm_sharded",
           "check_device_mesh"] + [f"commit_equal_{n}_{i}" for n in STAGED_COMMIT_N for i in STAGED_SETTINGS]
    emit({"phase": "staged", "card": smi, "n": N, "vs": os.path.basename(CHAIN), **out,
          "launches": {p: launches[p] for p in new},
          "widths": {k: {p: widths[k][p] for p in new} for k in ("padd", "pdbl")}})


PMUL_LANES = 1024  # the mesh phase's pmul_shared width
PMUL_SAMPLE = 8  # lanes of it held to the int oracle


def _swapped(pp, i: int, j: int):
    """A copy of the URS with generators i and j swapped."""
    from halo_accumulation_tpu_torch import pp as pp_mod

    gx, gy = pp.gs_x.clone(), pp.gs_y.clone()
    gx[:, [i, j]], gy[:, [i, j]] = gx[:, [j, i]], gy[:, [j, i]]
    return pp_mod.PublicParams(pp.n, gx, gy, pp.s, pp.h)


def _reject_text(fn):
    """None when fn returns, else the text of the ValueError it raises."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def phase_mesh(pp, smi, mesh, launches, widths) -> None:
    """The mesh paths on the staged phase's one-rank NCCL mesh, at N (see
    the module docstring); each path's seconds and launches."""
    import dataclasses

    from halo_accumulation_tpu_torch import acc, chain, fields as F, pcdl
    from halo_accumulation_tpu_torch.ops import curve as cv
    from halo_accumulation_tpu_torch.ops.field import FR
    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    dev = pp.device
    rng = np.random.default_rng(SEED + 2)
    coeffs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(N)]
    z, w = (int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2))
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R
    cd = FR.from_ints(coeffs, dev)
    C = pcdl.commit(cd, N - 1, w, pp)
    got = {}
    out = {"backend": "nccl", "world_size": mesh.size(), "n": N}
    with safe_rebuilds() as rebuilds:
        out["open_mesh_s"] = counted("open_mesh", MUST_LAUNCH["sortrows"],
                                     lambda: got.update(m=pcdl.open_(np.random.default_rng(3), cd, C, N - 1, z, w, pp,
                                                                     mesh=mesh, axis=sh.AXIS, v=v)), launches, widths)
        out["open_single_s"] = wall(lambda: got.update(s=pcdl.open_(np.random.default_rng(3), cd, C, N - 1, z, w, pp, v=v)))
    if rebuilds:
        raise AssertionError(f"mesh phase: open_ took its _safe rebuild {len(rebuilds)} times")
    if got["m"].serialize() != got["s"].serialize():
        raise AssertionError("open_(mesh=) bytes differ from the single-device open's")
    pcdl.succinct_check(C, N - 1, z, v, got["m"], pp)
    out["open_bytes_equal"] = len(got["m"].serialize())

    d, qss, accs = chain.load_chain(CHAIN)
    claims = [(q.C, q.d, q.z, q.v, q.pi) for qs in qss for q in qs]
    bad = list(claims)
    bad[5] = claims[5][:3] + ((claims[5][3] + 1) % F.R, claims[5][4])
    T = REJECT_TEXTS
    verdicts = {}
    out["succinct_check_batch_mesh_s"] = counted(
        "succinct_check_batch_mesh", {"padd", "pdbl"},
        lambda: verdicts.update(good=_reject_text(lambda: pcdl.succinct_check_batch(claims, pp, mesh=mesh))),
        launches, widths)
    verdicts["bad"] = _reject_text(lambda: pcdl.succinct_check_batch(bad, pp, mesh=mesh))
    single = [_reject_text(lambda: pcdl.succinct_check_batch(c, pp)) for c in (claims, bad)]
    if [verdicts["good"], verdicts["bad"]] != single or single != [None, T["row"].format(b=5)]:
        raise AssertionError(f"succinct_check_batch(mesh=): {verdicts}, without a mesh {single}")
    # rows and msm_sharded (stage 1 of the staged pipeline): no bucket kernel
    out["verify_chain_mesh_s"] = counted("verify_chain_mesh", MUST_LAUNCH["staged"] | VERIFY_ALSO,
                                         lambda: acc.verify_chain(d, qss, accs, pp, mesh=mesh), launches, widths)
    out["verify_chain_mesh_warm_s"] = wall(lambda: acc.verify_chain(d, qss, accs, pp, mesh=mesh))
    q4 = qss[4][1]
    q4_c = dataclasses.replace(q4, pi=dataclasses.replace(q4.pi, c=(q4.pi.c + 1) % F.R))
    last = dataclasses.replace(accs[-1], v=(accs[-1].v + 1) % F.R)
    tampered = [(T["v"].format(k=len(accs) - 1), (qss, accs[:-1] + [last], pp)),
                (T["row"].format(b=8), (qss[:4] + [[qss[4][0], q4_c]] + qss[5:], accs, pp)),
                (T["u0"].format(b=0), (qss, accs, _swapped(pp, 0, 1))),
                (T["u"], (qss, accs, _swapped(pp, 2, 3)))]
    for text, (qs, ac, key) in tampered:
        m = _reject_text(lambda: acc.verify_chain(d, qs, ac, key, mesh=mesh))
        s1 = _reject_text(lambda: acc.verify_chain(d, qs, ac, key))
        if m != s1 or m != text:
            raise AssertionError(f"verify_chain(mesh=) rejected with {m!r}, without a mesh {s1!r}, expected {text!r}")
    out["verify_chain_mesh_rejected"] = [t for t, _ in tampered]

    k = int.from_bytes(rng.bytes(40), "little") % F.R
    P = pp.gs_points(PMUL_LANES)
    out["pmul_shared_s"] = counted("pmul_shared", {"padd", "pdbl"},
                                   lambda: got.update(p=cv.pmul_shared(FR.from_ints([k], dev)[:, 0], P)), launches, widths)
    idx = [0, 1, 2, 511, 512, 1000, 1022, PMUL_LANES - 1][:PMUL_SAMPLE]
    gs = pp.gs_host(PMUL_LANES)
    if cv.to_host(cv.PointVec(*(a[:, idx] for a in got["p"]))) != [F.p_mul(k, gs[i]) for i in idx]:
        raise AssertionError("pmul_shared differs from fields.p_mul")
    out["pmul_shared_lanes"] = PMUL_LANES
    paths = ("open_mesh", "succinct_check_batch_mesh", "verify_chain_mesh", "pmul_shared")
    emit({"phase": "mesh", "card": smi, **out, "launches": {p: launches[p] for p in paths},
          "widths": {kk: {p: widths[kk][p] for p in paths} for kk in ("padd", "pdbl", "bucket_masked")}})


CHAIN_FILES = tuple(f"chain_{n}_{k}.bin" for n in (512, 1024, 2048, 4096, 8192, 16384) for k in (10, 100)) + (
    "chain_65536_4.bin",)
ROWPERM_MAX_K = 10  # rowperm runs on the files with at most this many steps


def _chain_rejects(d, qss, accs, pp):
    """[(verifier, expected text, call)] on tampered copies of a chain: the
    last accumulator's v + 1 through both verifiers (verify_chain's host
    step check; decide_many's decider of that step, whose row fails), and
    the last step's fresh claim with its U replaced by another point (U
    feeds that step's C, so the host step check rejects C_bar first, as in
    the JAX package) or with its c + 1 (only its row equation reads c)."""
    import dataclasses

    from halo_accumulation_tpu_torch import chain, fields as F

    T = REJECT_TEXTS
    K = len(accs)
    last = dataclasses.replace(accs[-1], v=(accs[-1].v + 1) % F.R)
    q = qss[-1][-1]
    b = sum(len(qs) for qs in qss) - 1
    bad_u = dataclasses.replace(q, pi=dataclasses.replace(q.pi, U=F.p_add(q.pi.U, pp.gs_host(1)[0])))
    bad_c = dataclasses.replace(q, pi=dataclasses.replace(q.pi, c=(q.pi.c + 1) % F.R))
    with_q = lambda x: qss[:-1] + [qss[-1][:-1] + [x]]  # noqa: E731
    return [
        ("verify_chain", T["v"].format(k=K - 1), lambda: chain.verify_chain_fast(d, qss, accs[:-1] + [last], pp)),
        ("decide_many", T["row"].format(b=0), lambda: chain.verify_chain_slow(accs[:-1] + [last], pp)),
        ("verify_chain", T["c_bar"].format(k=K - 1), lambda: chain.verify_chain_fast(d, with_q(bad_u), accs, pp)),
        ("verify_chain", T["row"].format(b=b), lambda: chain.verify_chain_fast(d, with_q(bad_c), accs, pp)),
    ]


def phase_chains(dev, smi, launches, widths) -> None:
    """Every committed chain on the card (see the module docstring): one
    line a file, then the phase's seconds."""
    from halo_accumulation_tpu_torch import chain, pcdl
    from halo_accumulation_tpu_torch import pp as pp_mod

    t0 = time.perf_counter()
    cache = os.path.join(REPO, ".chain_cache")
    found = sorted(f for f in os.listdir(cache) if f.startswith("chain_") and f.endswith(".bin"))
    if sorted(CHAIN_FILES) != found:
        raise AssertionError(f".chain_cache holds {found}, expected {sorted(CHAIN_FILES)}")
    built = {}
    for name in CHAIN_FILES:
        path = os.path.join(cache, name)
        d, qss, accs = chain.load_chain(path)
        n, K = d + 1, len(accs)
        pp = pp_mod.get_pp(n, dev)
        line = {"phase": "chains", "file": name, "n": n, "K": K, "card": smi}
        if n not in built:  # every file was built from default_rng(7): its first step is this one
            got = {}
            with safe_rebuilds() as rebuilds:
                s = counted(f"chains_build_{n}", MUST_LAUNCH["sortrows"] | OPEN_DEVICE_ALSO,
                            lambda: got.update(c=chain.build_chain(np.random.default_rng(7), n, 1, pp)), launches, widths)
            if rebuilds:
                raise AssertionError(f"build_chain at n = {n} took open_'s _safe rebuild")
            built[n] = b"".join(chain.step_records(*got["c"][1:]))
            line["first_step_build_s"] = s
        raw = open(path, "rb").read()
        off = 16 + (8 if raw[:8] == chain.CHAIN_MAGIC else 0)
        if raw[off : off + len(built[n])] != built[n]:
            raise AssertionError(f"build_chain(default_rng(7), {n}, 1) differs from {name}'s first step")
        line["first_step_bytes_equal"] = len(built[n])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for impl in ("sortrows", "rowperm") if K <= ROWPERM_MAX_K else ("sortrows",):
            chunks, real = [], pcdl.check_many_device
            pcdl.check_many_device = lambda checks, p: chunks.append(len(checks)) or real(checks, p)
            try:
                with env("HALO_TPU_MSM_IMPL", impl):
                    must = MUST_LAUNCH[impl] | VERIFY_ALSO
                    tag = f"chains_{n}_{K}_{impl}"
                    res = {"verify_chain_s": [counted(f"{tag}_verify_chain", must,
                                                      lambda: chain.verify_chain_fast(d, qss, accs, pp), launches, widths),
                                              wall(lambda: chain.verify_chain_fast(d, qss, accs, pp))]}
                    chunks.clear()
                    res["decide_many_s"] = [counted(f"{tag}_decide_many", must, lambda: chain.verify_chain_slow(accs, pp),
                                                    launches, widths)]
                    res["decide_many_chunks"] = list(chunks)
                    res["decide_many_s"].append(wall(lambda: chain.verify_chain_slow(accs, pp)))
                    rejects = _chain_rejects(d, qss, accs, pp)
                    for _, text, fn in rejects:
                        _expect_reject(fn, text)
                    res["rejected"] = [[v, t] for v, t, _ in rejects]
            finally:
                pcdl.check_many_device = real
            want = [min(10, K - i) for i in range(0, K, 10)]
            if res["decide_many_chunks"] != want:
                raise AssertionError(f"{name} {impl}: decide_many chunks {res['decide_many_chunks']}, expected {want}")
            line[impl] = res
        line["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        line["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        emit(line)
    emit({"phase": "chains_done", "files": len(CHAIN_FILES), "card": smi, "phase_s": time.perf_counter() - t0,
          "rowperm_on": [f for f in CHAIN_FILES if int(f[:-4].split("_")[2]) <= ROWPERM_MAX_K]})


def phase_chain(pp, smi, launches, widths):
    from halo_accumulation_tpu_torch import chain

    d, qss, accs = chain.load_chain(CHAIN)
    K = len(accs)
    paths = {
        "verify_chain": lambda: chain.verify_chain_fast(d, qss, accs, pp),
        "decide_many": lambda: chain.verify_chain_slow(accs, pp),
    }
    out, warm = {}, {}
    for impl in ("sortrows", "rowperm", "staged"):
        first, warm[impl] = {}, {}
        with env("HALO_TPU_MSM_IMPL", impl):
            for path, fn in paths.items():
                tag = path if impl == "sortrows" else f"{path}_{impl}"
                first[path] = counted(tag, MUST_LAUNCH[impl] | VERIFY_ALSO, fn, launches, widths)
            for path, fn in paths.items():
                warm[impl][path] = float(np.median([wall(fn) for _ in range(3)]))
            if impl == "sortrows":
                oracle_warm = _warm_on_oracle(paths)
            tampered = _tampered(d, qss, accs, pp)
            for text, fn in tampered:
                _expect_reject(fn, text)
        out[impl] = {"verify_chain_s": first["verify_chain"], "decide_many_s": first["decide_many"],
                     "verify_chain_warm_s": warm[impl]["verify_chain"],
                     "decide_many_warm_s": warm[impl]["decide_many"],
                     "tamper_rejected": [text for text, _ in tampered]}
        if impl == "sortrows":
            out[impl].update({f"{path}_warm_s_oracle_host_ops": s for path, s in oracle_warm.items()})
    emit({"phase": "chain", "chain": os.path.basename(CHAIN), "d": d, "K": K, "card": smi, **out,
          "launches": {k: v for k, v in launches.items() if not k.startswith("prove")}})
    return paths, warm["sortrows"]


def _warm_on_oracle(paths) -> dict:
    """Median warm seconds of each path over three runs with the host ops
    forced onto the Python oracle (hostops.use_native() False), the
    native backend's yardstick."""
    from halo_accumulation_tpu_torch import hostops

    hostops._use_native = False
    try:
        return {path: float(np.median([wall(fn) for _ in range(3)])) for path, fn in paths.items()}
    finally:
        hostops._use_native = None


def phase_profile(paths, warm, smi) -> None:
    """One warm run of each path under torch.profiler (device items) and
    one under cProfile (host functions), tables written to PROFILE_DIR.
    Device busy time is
    the union of the trace's device intervals (kernels, copies, memsets);
    idle share is 1 - busy / wall, against the profiled wall time and,
    where warm holds the path, against its unprofiled warm median."""
    from torch.profiler import ProfilerActivity, profile

    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    os.makedirs(PROFILE_DIR, exist_ok=True)
    for path, fn in paths.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t
        dev, launches = _runtime_events(prof)
        if not dev:
            raise AssertionError(f"{path}: the trace holds no device activity")
        busy_us = _busy_us(dev)
        items: dict[str, list] = {}
        for start, end, name in dev:
            it = items.setdefault(name, [0, 0.0])
            it[0] += 1
            it[1] += end - start
        top = sorted(items.items(), key=lambda kv: -kv[1][1])
        # device ms and launches per port kernel, all its instances together
        kernel_ms = {k: [sum(c for n, (c, _) in items.items() if f"{k}_" in n),
                         sum(us for n, (_, us) in items.items() if f"{k}_" in n) / 1e3] for k in ck.KERNELS}
        with open(os.path.join(PROFILE_DIR, f"profile_{path}.txt"), "w") as f:
            f.write(f"{smi}\n{path}: wall {prof_wall:.6f} s, device busy {busy_us / 1e3:.3f} ms, "
                    f"{len(dev)} device events\n\n")
            for name, (calls, us) in top:
                f.write(f"{us / 1e3:12.3f} ms {calls:7d}  {name}\n")
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
              "unprofiled_warm_s": warm.get(path), "device_busy_ms": busy_us / 1e3,
              "device_events": len(dev), "host_launches": dict(launches), "idle_share": 1 - busy_s / prof_wall,
              "idle_share_unprofiled": 1 - busy_s / warm[path] if path in warm else None,
              "top_device_ms": [[n[:80], c, us / 1e3] for n, (c, us) in top[:8]], "kernel_ms": kernel_ms,
              "host_cprofile_s": st.total_tt, "host_replays_s": replay_s,
              "host_top_own_s": [[name, tt] for tt, _, name in own[:8]]})


def _profiled(fn) -> dict:
    """One run of fn under torch.profiler: its wall seconds, device busy ms
    (the union of the device intervals), device events and the host calls
    that launched them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    dev, launches = _runtime_events(prof)
    if not dev:
        raise AssertionError("the trace holds no device activity")
    busy_ms = _busy_us(dev) / 1e3
    return {"profiled_wall_s": prof_wall, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / 1e3 / prof_wall,
            "device_events": len(dev), "host_launches": dict(launches)}


def phase_graphs(pp, smi, d, qss, accs) -> None:
    """Graphs on (the default) against graphs off (runtime._eager_graphs)
    on verify_chain, decide_many and one prover step per prove setting:
    GRAPH_REPS warm runs of each in turns (on, off, on, off, ...), host
    seconds; then one run of each under torch.profiler (device busy, idle
    share, device events, launching host calls).  Then every captured
    body of the chain paths run eagerly under set_sync_debug_mode("error")
    (strict_bodies), each graph's warm-up and capture seconds, and the
    card's reserved memory after every phase."""
    from halo_accumulation_tpu_torch import chain, runtime

    paths = {"verify_chain": (None, lambda: chain.verify_chain_fast(d, qss, accs, pp)),
             "decide_many": (None, lambda: chain.verify_chain_slow(accs, pp))}
    for path, impl, open_device, _ in PROVES:
        paths[f"{path}_1step"] = ((impl, open_device),
                                  lambda: chain.build_chain(np.random.default_rng(7), N, 1, pp))
    modes = {"graphs": contextlib.nullcontext, "eager": runtime._eager_graphs}
    out = {}
    for path, (setting, fn) in paths.items():
        reps = GRAPH_REPS[0 if setting is None else 1]
        with contextlib.ExitStack() as stack:
            if setting is not None:
                stack.enter_context(env("HALO_TPU_MSM_IMPL", setting[0]))
                stack.enter_context(env("HALO_TPU_OPEN_DEVICE", setting[1]))
            fn()
            walls = {m: [] for m in modes}
            for _ in range(reps):
                for m, ctx in modes.items():
                    with ctx():
                        walls[m].append(wall(fn))
            out[path] = {}
            for m, ctx in modes.items():
                with ctx():
                    prof = _profiled(fn)
                med = float(np.median(walls[m]))
                out[path][m] = {"warm_s_median": med, "warm_s_min": min(walls[m]), "warm_s_max": max(walls[m]),
                                "warm_s": walls[m], **prof,
                                "idle_share_warm": 1 - prof["device_busy_ms"] / 1e3 / med}
    with strict_bodies([]) as names:
        for path in ("verify_chain", "decide_many"):
            paths[path][1]()
    if names != ["verdicts", "verdicts"]:
        raise AssertionError(f"the chain paths ran the bodies {names}, expected two verdict graphs")
    emit({"phase": "graphs", "card": smi, "n": N, "reps": GRAPH_REPS, **out, "bodies_sync_free": names,
          "graphs_held": len(runtime.graphs),
          "capture_s": [[k[0], k[1], "the URS" if g.holds[0] is pp else "a tampered URS", g.capture_s]
                        for k, g in runtime.graphs.items()],
          "memory_reserved_bytes": torch.cuda.memory_reserved(),
          "max_memory_reserved_bytes": torch.cuda.max_memory_reserved()})


def phase_api(smi) -> None:
    """The package docstring's example through api, the façade a user
    calls: setup at N (the card), commit, open and check a plain claim of
    degree N - 1, verify the chain; a wrong value must be rejected."""
    from halo_accumulation_tpu_torch import api, chain

    pp = api.setup(N)
    rng = np.random.default_rng(0)
    p = [int.from_bytes(rng.bytes(31), "little") for _ in range(5)]
    z = 7
    C = api.commit(p, N - 1, None, pp)
    t = time.perf_counter()
    pi = api.open(rng, p, C, N - 1, z, None, pp)
    open_s = time.perf_counter() - t
    api.check(C, N - 1, z, api.eval_poly(p, z), pi, pp)
    _expect_reject(lambda: api.check(C, N - 1, z, api.eval_poly(p, z) + 1, pi, pp),
                   REJECT_TEXTS["row"].format(b=0))
    d, qss, accs = chain.load_chain(CHAIN)
    api.verify_chain(d, qss, accs, pp)
    emit({"phase": "api", "card": smi, "n": N, "device": str(pp.device), "open_s": open_s, "checked": True})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shutil.rmtree(URS_CACHE, ignore_errors=True)
    os.environ["HALO_TPU_URS_CACHE"] = URS_CACHE
    smi, sm_mhz = phase_device()
    phase_native(smi)
    pp = phase_urs(dev)
    res = phase_kernels(dev, pp, sm_mhz)
    launches: dict[str, dict] = {}
    widths: dict[str, dict] = {}
    phase_prove(pp, smi, launches, widths)
    phase_open_copies(pp, smi)
    phase_api(smi)
    paths, warm = phase_chain(pp, smi, launches, widths)
    import torch.distributed as dist

    from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank needs no network: loopback only
    mesh = sh.make_mesh()  # one NCCL rank, formed once for the staged and mesh phases
    try:
        phase_staged(pp, smi, mesh, launches, widths)
        phase_mesh(pp, smi, mesh, launches, widths)
    finally:
        dist.destroy_process_group()
    with env("HALO_TPU_MSM_IMPL", "sortrows"):
        phase_profile(paths, warm, smi)
    from halo_accumulation_tpu_torch import chain

    for path, impl, open_device, _ in PROVES:
        with env("HALO_TPU_MSM_IMPL", impl), env("HALO_TPU_OPEN_DEVICE", open_device):
            phase_profile({f"{path}_1step": lambda: chain.build_chain(np.random.default_rng(7), N, 1, pp)}, {}, smi)
    phase_graphs(pp, smi, *chain.load_chain(CHAIN))
    phase_chains(dev, smi, launches, widths)
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    kernels = []
    for name, k in ck.KERNELS.items():
        total = sum(n[name] for n in launches.values())
        if total == 0:
            raise AssertionError(f"kernel {name} was launched on no path")
        kernels.append({"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                        **({"note": k.note} if k.note else {}),
                        "launches": total, "launches_by_path": {p: n[name] for p, n in launches.items()},
                        **{key: res[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                           "bound_by", "library_ms")},
                        **{key: res[name][key] for key in ("lanes", "k", "split", "threads", "by_threads", "at_path_shape",
                                                           "by_fill", "by_width", "by_lanes", "by_field", "cases")
                           if key in res[name]}})
    for k in WIDTHS_KEPT:
        emit({"phase": f"{k}_widths", "note": f"{k} launches by width (lanes; columns for the bucket kernels) "
                                              "on each counted path", **{p: w for p, w in widths[k].items() if w}})
    emit({"phase": "done", "total_s": round(time.perf_counter() - t0, 3)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
