"""Write the small fixtures the port's CPU tests read, with the JAX package.

    python3 tools/port_test_chain.py [chain16] [open16]

chain<N> saves the JAX package's build_chain(
default_rng(7), N, 2) (d = N - 1: two steps, three random hiding instances)
in the tagged chain layout as tests/data/chain_<N>_2.bin.  open16 writes
tests/data/open_16.json: the JAX package's pcdl.open_ proof bytes for the
claim tests/test_torch_mesh_open.py opens (coefficients and z from
default_rng(3), n = 16), from default_rng(5), without hiding and with
w = 12345.  The port's tests then hold its mesh paths to the reference's
output, which the JAX package takes minutes to make on the CPU (an
n = 16 open: about 80 s with its compile, 26 s after; the n = 16 chain 17
minutes on one core), more than a test file may take.  With no argument
it writes both; each argument can run in a process of its own.  The
port's own build_chain gives the same chain bytes (at n = 16 and 8).
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HALO_TPU_PLATFORM", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0").strip()

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo_accumulation_tpu import chain, fields as F, pcdl, pp as pp_mod, runtime  # noqa: E402
from halo_accumulation_tpu.ops.field import FR  # noqa: E402

DATA = os.path.join(REPO, "tests", "data")
HIDING = {"plain": None, "hiding": 12345}


def write_chain(n: int) -> None:
    out = os.path.join(DATA, f"chain_{n}_2.bin")
    d, qss, accs = chain.build_chain(np.random.default_rng(7), n, 2, pp_mod.get_pp(n, use_disk_cache=False))
    chain.save_chain(out, d, qss, accs)
    print(f"wrote {out}: d = {d}, {len(accs)} steps, {os.path.getsize(out)} bytes", flush=True)


def write_open(n: int) -> None:
    rng = np.random.default_rng(3)
    coeffs = [chain.rand_scalar(rng) for _ in range(n)]
    z = chain.rand_scalar(rng)
    pp = pp_mod.get_pp(n, use_disk_cache=False)
    proofs = {}
    for name, w in HIDING.items():
        C = pcdl.commit(FR.from_ints(coeffs), n - 1, w, pp)
        pi = pcdl.open_(np.random.default_rng(5), FR.from_ints(coeffs), C, n - 1, z, w, pp)
        proofs[name] = pi.serialize().hex()
    out = os.path.join(DATA, f"open_{n}.json")
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R
    with open(out, "w") as f:
        json.dump({"n": n, "claim_seed": 3, "open_seed": 5, "hiding": HIDING, "z": str(z), "v": str(v),
                   "proofs": proofs}, f, indent=1)
        f.write("\n")
    print(f"wrote {out}", flush=True)


def main() -> None:
    runtime.init()
    for arg in sys.argv[1:] or ["chain16", "open16"]:
        if arg.startswith("chain"):
            write_chain(int(arg[5:]))
        elif arg.startswith("open"):
            write_open(int(arg[4:]))
        else:
            raise SystemExit(f"unknown fixture {arg!r}: chain<N> or open<N>")


if __name__ == "__main__":
    main()
