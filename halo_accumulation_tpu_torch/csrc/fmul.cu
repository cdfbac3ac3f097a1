// fmul: Fq modular multiply, (18, n) x (18, n) -> (18, n) canonical limbs.
//
// Replaces the TPU kernel _fmul_kernel / _fmul_call in
// halo_accumulation_tpu/ops/pallas_kernels.py.  The production path calls
// it only in the verifiers' projective equality; its body (halo::mul) is the
// inner loop of the padd, pdbl and bucket kernels, and this launch tests and
// times that body alone.
//
// One thread per lane: load both operands' limbs into 8 words, one
// pseudo-Mersenne multiply (103 32-bit products, field.cuh), store canonical
// limbs.  Bound on the H100: the int64 boundary, 3 x 18 x 8 = 432 bytes a
// lane against 96 for the 32-byte values it carries; the loads and stores
// are coalesced along the lane axis, and the multiply is a small share of
// the time: from HBM at 65,536 lanes a launch takes 1.06 to 1.07 times a
// torch.add of the same planes on the H100 (PERF.md).  The caller picks the block size (threads, a multiple of 32 up
// to 1024); chip_smoke.py times 64, 128 and 256 at 65,536 lanes.  Left for
// later: narrower boundary planes.
#include <cuda_runtime.h>
#include "field.cuh"

__global__ void fmul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                            int64_t* __restrict__ o, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  halo::store_fe(o, n, i, halo::mul(halo::load_fe(a, n, i), halo::load_fe(b, n, i)));
}

extern "C" int halo_fmul(const void* a, const void* b, void* o, int64_t n, int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fmul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)o, n);
  }
  return (int)cudaGetLastError();
}
