// fmul: Fq modular multiply, (18, n) x (18, n) -> (18, n) lazy limbs.
//
// Replaces the TPU kernel _fmul_kernel / _fmul_call in
// halo_accumulation_tpu/ops/pallas_kernels.py.  The production path never
// calls it on its own: its body (halo::mul) is the inner loop of the padd,
// pdbl and masked bucket kernels, and this launch exists to test and time
// that body alone.
//
// Boundary: int64 limb planes as the torch code holds them (every limb fits
// in 31 bits and is narrowed to uint32 in registers).  One thread per lane.
// Bound on the H100: integer multiply-add issue (324 limb products plus
// ~400 reduction products per multiply, all in registers); the 288 bytes
// each thread reads and 144 it writes are coalesced along the lane axis.
// Left for later: Montgomery 4 x 64 or IMAD-chain limbs, several lanes per
// thread, and int32 boundary planes to halve the bytes moved.
#include <cuda_runtime.h>
#include "field.cuh"

__global__ void fmul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                            int64_t* __restrict__ o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  halo::store_fe(o, n, i, halo::mul(halo::load_fe(a, n, i), halo::load_fe(b, n, i)));
}

extern "C" int halo_fmul(const void* a, const void* b, void* o, int64_t n, void* stream) {
  if (n > 0) {
    const int threads = 64;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fmul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)o, n);
  }
  return (int)cudaGetLastError();
}
