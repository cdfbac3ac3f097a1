"""CPU seconds of the port's n = 512 prover and verifier steps in the plain
twins, for one or more checkouts, each in a process of its own, in the
order given.

    python3 tools/port_open_cpu.py CHECKOUT [CHECKOUT ...]

Each checkout (a directory holding `halo_accumulation_tpu_torch/`, e.g. a
`git archive` of another commit) runs on one torch thread, as the tests
do: the URS at n = 512 on the CPU, the commitment to a random polynomial
of degree 299 (tests/test_torch_open_device.py's claim), its open on the
host transcript (HALO_TPU_OPEN_DEVICE=0) and on the device transcript
(=1), which must write the same bytes, and pcdl.check of the proof.
Prints one JSON line a checkout: seconds of each step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def one(checkout: str) -> dict:
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from halo_accumulation_tpu_torch import fields as F, pcdl, pp as pp_mod
    from halo_accumulation_tpu_torch.ops.field import FR

    n, d = 512, 511
    pp = pp_mod.get_pp(n, "cpu")
    rng = np.random.default_rng(20261017)
    p = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(300)]
    z = int.from_bytes(rng.bytes(40), "little") % F.R
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(p)) % F.R
    cd = FR.from_ints(p)
    out = {"checkout": checkout}
    t = time.perf_counter()
    C = pcdl.commit(cd, d, None, pp)
    out["commit_s"] = time.perf_counter() - t
    proofs = []
    for flag in ("0", "1"):
        os.environ["HALO_TPU_OPEN_DEVICE"] = flag
        t = time.perf_counter()
        proofs.append(pcdl.open_(np.random.default_rng(1), cd, C, d, z, None, pp, v=v))
        out["open_host_s" if flag == "0" else "open_device_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pcdl.check(C, d, z, v, proofs[0], pp)
    out["check_s"] = time.perf_counter() - t
    out["same_bytes"] = proofs[0].serialize() == proofs[1].serialize()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    rc = 0
    for checkout in sys.argv[1:]:
        path = os.path.abspath(checkout)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", path], cwd=path).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
