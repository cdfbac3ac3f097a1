// pdbl: complete projective point doubling, 3 x (18, n) -> 3 x (18, n).
//
// Replaces the TPU kernel _pdbl_kernel / _pdbl_call in
// halo_accumulation_tpu/ops/pallas_kernels.py (RCB16 algorithm 9, a = 0;
// ops/limbs.py pdbl_list).  On the card every curve.pdbl goes here: the
// msm_rows windows and the Horner window combine.
//
// Boundary: int64 limb planes (limbs fit in 31 bits; uint32 in registers).
// One thread per lane; 8 multiplies and 3 small multiplies per double.
// Bound on the H100: integer multiply-add issue.  The Horner combine calls
// it on one to ten lanes, where it is launch-bound instead.
// Left for later: c doublings per launch for the Horner combine, and the
// limb work noted in fmul.cu.
#include <cuda_runtime.h>
#include "curve.cuh"

__global__ void pdbl_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                            const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                            int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  halo::store_pt(ox, oy, oz, n, i, halo::pdbl(halo::load_pt(x, y, z, n, i)));
}

extern "C" int halo_pdbl(const void* x, const void* y, const void* z, void* ox, void* oy,
                         void* oz, int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 64;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    pdbl_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)z, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
