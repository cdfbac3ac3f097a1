"""fmul of the PyTorch/CUDA port at 65,536 lanes, hot in L2 and from HBM,
beside torch.add of the same int64 limb planes, for one or more checkouts.

    python3 tools/port_fmul_floor.py CHECKOUT [CHECKOUT ...]

Each checkout (a directory holding `halo_accumulation_tpu_torch/`, e.g. a
`git archive` of another commit) runs in a process of its own, in the order
given, so a parent and a change can be compared in turns on one card:
`port_fmul_floor.py parent . . parent`.  Each run builds that checkout's
kernels and prints one JSON line: microseconds a launch, ten launches
queued behind a device sleep (the host's dispatch hidden), median of
seven, for
  hot:      the same a, b every launch (28.3 MB, which the 50 MB L2 holds);
  rotated:  each launch its own pair of ROTATE (189 MB), so the planes come
            from HBM;
and torch.add of the same planes both ways: the same bytes and no
arithmetic, the int64 boundary's floor on this card.  The checkout's
default block size is used.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

LANES = 1 << 16
ROTATE = 10
QUEUE_CYCLES = 10_000_000  # about 5 ms of SM clock: covers the enqueue of ten launches


def one(checkout: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(checkout))
    from halo_accumulation_tpu_torch.ops import cuda_kernels as ck

    def us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(QUEUE_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times)) * 1e3 / 10

    rng = np.random.default_rng(20261016)
    lim = rng.integers(0, 1 << 15, size=(2, 18, LANES), dtype=np.int64)
    lim[:, 17] &= 3  # values below 2^257, the boundary's bound
    a, b = (torch.from_numpy(x).cuda() for x in lim)
    if not torch.equal(ck.FQ.canon(ck.fmul(a, b)), ck.FQ.canon(ck.fmul_plain(a, b))):
        raise AssertionError(f"{checkout}: fmul != its plain twin")
    pairs = [(torch.roll(a, i, 1), torch.roll(b, i, 1)) for i in range(ROTATE)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"checkout": checkout, "card": smi, "lanes": LANES,
            "fmul_us": us(lambda: [ck.fmul(a, b) for _ in range(10)]),
            "fmul_us_rotated": us(lambda: [ck.fmul(x, y) for x, y in pairs]),
            "plane_add_us": us(lambda: [torch.add(a, b) for _ in range(10)]),
            "plane_add_us_rotated": us(lambda: [torch.add(x, y) for x, y in pairs])}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for checkout in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", checkout], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
