"""chip_smoke.py's graphs phase for one or more checkouts of the PyTorch/CUDA
port, each in a process of its own, in the order given.

    python3 tools/port_graphs_ab.py CHECKOUT [CHECKOUT ...]

Each checkout (a directory holding `halo_accumulation_tpu_torch/` and
`chip_smoke.py`, e.g. a `git archive` of another commit) builds its
kernels, makes the 16,384-generator URS on the card and runs its own
`chip_smoke.phase_graphs` on `.chain_cache/chain_16384_10.bin` of this
repository: verify_chain, decide_many and one prover step per prove
setting with graphs on and off in turns, warm host seconds and, under
torch.profiler, device busy ms, idle share and device events.  Run a
parent and a change in turns on one card (`port_graphs_ab.py parent . .
parent`); each prints the phase's JSON line, tagged with its checkout.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = os.path.join(REPO, ".chain_cache", "chain_16384_10.bin")


def one(checkout: str) -> None:
    """phase_graphs of the checkout at the absolute path `checkout`."""
    import json

    sys.path.insert(0, checkout)
    import chip_smoke
    from halo_accumulation_tpu_torch import chain, pp as pp_mod

    chip_smoke.CHAIN = CHAIN
    smi = chip_smoke.phase_device()[0]
    pp = pp_mod.get_pp(chip_smoke.N, "cuda")
    real_emit = chip_smoke.emit
    chip_smoke.emit = lambda obj: real_emit({"checkout": checkout, **obj}) if obj.get("phase") == "graphs" else None
    chip_smoke.phase_graphs(pp, smi, *chain.load_chain(CHAIN))
    print(json.dumps({"checkout": checkout, "done": True}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    rc = 0
    for checkout in sys.argv[1:]:
        path = os.path.abspath(checkout)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", path], cwd=path).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
