"""halo_accumulation_tpu_torch: the Halo accumulation verifier in PyTorch.

The PyTorch and CUDA port of `halo_accumulation_tpu` (which stays the
reference).  This package holds the verifier side of an accumulation chain:
Pasta field and curve arithmetic on (18, *batch) int64 limb tensors, the
sort-payload Pippenger MSM, the URS, PCDL succinct checks and full checks,
the ASDL verifier and decider, and chain loading.  On a CUDA device the
point additions, doublings and the MSM's bucket reduction run as
hand-written Hopper kernels (`csrc/`, built with nvcc at first use); on the
CPU the same functions run their plain PyTorch twins.  Modules keep the JAX
package's names; the list-form limb math of its `ops/limbs.py` lives in
`csrc/field.cuh` and `csrc/curve.cuh`, and the Pallas kernels' wrappers
become `ops/cuda_kernels.py`.

    from halo_accumulation_tpu_torch import chain, pp
    d, qss, accs = chain.load_chain(".chain_cache/chain_16384_10.bin")
    params = pp.get_pp(d + 1, "cuda")
    chain.verify_chain_fast(d, qss, accs, params)   # raises on reject
    chain.verify_chain_slow(accs, params)

It imports torch and never jax.
"""

__version__ = "0.1.0"
