"""Observability of the port: the staged MSM's cost model and a
torch.profiler trace hook.

Counterpart of `halo_accumulation_tpu/profiling.py`:

  * msm_cost / msm_cost_groups count complete adds and field multiplies of
    the staged Pippenger and of the bucket pipelines' real per-window
    (pad, beff) structure, with the JAX package's counts and keys;
    msm_throughput* turn a measured time into achieved rates and a share
    of the H100's 32-bit integer multiply rate (the bound constants of
    PERF.md's kernel table: 88 32-bit multiplies a multiply modulo q on
    8 x 32-bit words, 132 SMs x 64 a clock at 1.98 GHz);
  * trace(label): torch.profiler over the block (CPU activity, and CUDA
    activity when a card is present) when HALO_TPU_TRACE=<dir> is set,
    written as the Chrome trace <dir>/<label>.json.  A replayed CUDA graph
    shows as one launch there: read kernel launch counts from
    ops/cuda_kernels (launch_counts), which counts a replay's launches.
"""

from __future__ import annotations

import contextlib
import os

# least 32-bit multiplies of one multiply modulo q on 8 x 32-bit words
# (64 products and 24 for the reduction); a complete projective add (RCB16,
# a = 0) is 12 multiplies and 2 small ones, a double about 10
U32_MULS_PER_FMUL = 88
FMUL_PER_PADD = 14.0
FMUL_PER_PDBL = 10.0

# H100 SXM: 132 SMs, 64 32-bit integer multiply(-add)s a clock each, at the
# top SM clock of 1980 MHz
H100_INT32_MULS_PER_S = 132 * 64 * 1.98e9


def msm_cost(N: int, c: int, pad: int, chunks: int = 1) -> dict:
    """Complete-add counts for the staged Pippenger at (N, c, pad), the
    points in `chunks` chunks: u32_gops is the giga 32-bit multiplies."""
    W = (255 + c - 1) // c
    B = 1 << c
    s1 = W * B * max(0, pad - 1) * chunks + (chunks - 1) * W * B
    s2 = W * B * c  # lg(B) = c suffix steps
    s3 = W * (B - 1)
    s4_dbl = 255
    padds = s1 + s2 + s3 + W
    fmuls = padds * FMUL_PER_PADD + s4_dbl * FMUL_PER_PDBL
    return {
        "padds": int(padds),
        "fmuls": int(fmuls),
        "u32_gops": round(fmuls * U32_MULS_PER_FMUL / 1e9, 1),
    }


def msm_cost_groups(N: int, c: int, pads: list, beffs: list) -> dict:
    """Complete-add counts with the real per-window (pad, beff) structure
    (ops/msm.pinned_pads, _beffs): bucket reduction beff (pad - 1) a window,
    2 lg(beff) beff suffix-doubling adds, and the Horner combine."""
    padds = 0
    for pad, beff in zip(pads, beffs):
        padds += beff * max(0, pad - 1)
        lgB = max(0, beff.bit_length() - 1)
        padds += 2 * lgB * beff
    W = len(pads)
    padds += W  # horner adds
    fmuls = padds * FMUL_PER_PADD + 255 * FMUL_PER_PDBL
    return {
        "padds": int(padds),
        "fmuls": int(fmuls),
        "u32_gops": round(fmuls * U32_MULS_PER_FMUL / 1e9, 1),
    }


def _rates(cost: dict, N: int, seconds: float) -> dict:
    gops = cost["u32_gops"] / seconds
    return {
        **cost,
        "points_per_s": round(N / seconds, 1),
        "achieved_u32_gops_per_s": round(gops, 1),
        "h100_int32_util_est": round(gops * 1e9 / H100_INT32_MULS_PER_S, 3),
    }


def msm_throughput_groups(N: int, c: int, pads: list, beffs: list, seconds: float) -> dict:
    return _rates(msm_cost_groups(N, c, pads, beffs), N, seconds)


def msm_throughput(N: int, c: int, pad: int, seconds: float, chunks: int = 1) -> dict:
    return _rates(msm_cost(N, c, pad, chunks), N, seconds)


@contextlib.contextmanager
def trace(label: str = "halo"):
    """torch.profiler over the block when HALO_TPU_TRACE=<dir> is set (the
    profile is yielded; None when tracing is off); <dir>/<label>.json is
    written at its end."""
    trace_dir = os.environ.get("HALO_TPU_TRACE")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
