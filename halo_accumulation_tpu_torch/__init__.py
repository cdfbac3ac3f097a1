"""halo_accumulation_tpu_torch: Halo accumulation in PyTorch.

The PyTorch and CUDA port of `halo_accumulation_tpu` (which stays the
reference).  This package builds and checks accumulation chains: Pasta
field and curve arithmetic on (18, *batch) int64 limb tensors, the
sort-payload and row-permutation Pippenger MSMs (HALO_TPU_MSM_IMPL=sortrows,
the default, or rowperm), the URS, PCDL commit / open / succinct and full
checks, the ASDL prover, verifier and decider, and chain building, saving
and loading.  On a CUDA device the point additions, doublings, both
MSMs' bucket reductions, field inversions and the IPA open's round
challenges run as hand-written Hopper kernels (`csrc/`, built with nvcc at
first use); on the CPU the same functions run their plain PyTorch twins.
The protocol's single-point host ops run on a native C++ backend
(`native/`, built with g++ at first use).  Modules keep the JAX package's names; the list-form limb
math of its `ops/limbs.py` lives in `csrc/field.cuh` and `csrc/curve.cuh`,
and the Pallas kernels' wrappers become `ops/cuda_kernels.py`.

Entry points run on the card unless the caller names the CPU.  `api` holds
the JAX package's façade, verb for verb:

    import numpy as np
    from halo_accumulation_tpu_torch import api, load_chain
    pp = api.setup(16384)                     # on "cuda"; api.setup(n, "cpu") for the CPU
    rng = np.random.default_rng(0)
    p = [int.from_bytes(rng.bytes(31), "little") for _ in range(5)]
    d, z = 16383, 7
    C = api.commit(p, d, None, pp)
    pi = api.open(rng, p, C, d, z, None, pp)
    api.check(C, d, z, api.eval_poly(p, z), pi, pp)   # raises on reject
    d, qss, accs = load_chain(".chain_cache/chain_16384_10.bin")
    api.verify_chain(d, qss, accs, pp)                 # raises on reject

On the card the verdicts of `verify_chain` and `decide_many` and each
device-transcript open run as captured CUDA graphs (`runtime.graphed`).
`parallel/` holds the multi-device paths on torch.distributed (NCCL on
cards, gloo on the CPU): the sharded MSM, the `mesh=` argument of
`pcdl.open_`, `pcdl.succinct_check_batch` and `acc.verify_chain`, and the
dry run `parallel.dryrun.dryrun_multichip`.

It imports torch and never jax.
"""

from halo_accumulation_tpu_torch import api  # noqa: E402
from halo_accumulation_tpu_torch.chain import (  # noqa: E402
    build_chain,
    load_chain,
    random_instance,
    save_chain,
    verify_chain_fast,
    verify_chain_slow,
)
from halo_accumulation_tpu_torch.pp import get_pp  # noqa: E402

__version__ = "0.1.0"
