// padd: complete projective point addition, 2 x 3 x (18, n) -> 3 x (18, n).
//
// Replaces the TPU kernel _padd_kernel / _padd_call in
// halo_accumulation_tpu/ops/pallas_kernels.py (RCB16 algorithm 7, a = 0,
// b3 = 15; the list-form formulas of ops/limbs.py padd_list).  On the card
// every curve.padd goes here: the msm_rows tables and tree sums, the bucket
// weighting, the Horner window combine and the URS sums.
//
// Boundary: int64 limb planes (limbs fit in 31 bits; uint32 in registers).
// One thread per lane; 12 multiplies and 2 small multiplies per add.
// Bound on the H100: integer multiply-add issue and register pressure (a
// point pair plus live temporaries is a few hundred 32-bit values per
// thread, so occupancy is low); memory traffic is 864 bytes in, 432 out per
// lane.  Each field multiply is a call (see field.cuh), which keeps the
// build to seconds.
// Left for later: fewer live temporaries, Montgomery 4 x 64 limbs, and
// fusing the adds of a tree level into one launch.
#include <cuda_runtime.h>
#include "curve.cuh"

__global__ void padd_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                            const int64_t* __restrict__ z1, const int64_t* __restrict__ x2,
                            const int64_t* __restrict__ y2, const int64_t* __restrict__ z2,
                            int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                            int64_t* __restrict__ oz, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const halo::Pt P = halo::load_pt(x1, y1, z1, n, i);
  const halo::Pt Q = halo::load_pt(x2, y2, z2, n, i);
  halo::store_pt(ox, oy, oz, n, i, halo::padd(P, Q));
}

extern "C" int halo_padd(const void* x1, const void* y1, const void* z1, const void* x2,
                         const void* y2, const void* z2, void* ox, void* oy, void* oz,
                         int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 64;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    padd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x1, (const int64_t*)y1, (const int64_t*)z1, (const int64_t*)x2,
        (const int64_t*)y2, (const int64_t*)z2, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
