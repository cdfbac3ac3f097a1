// finv: batched Fermat inversion a^(p - 2) of (18, n) limb planes, over Fq
// or Fr (p = q or r), -> (18, n) canonical limbs; 0 maps to 0.
//
// No Pallas counterpart: in the JAX package this is XLA glue,
// Field.pow_const (halo_accumulation_tpu/ops/field.py:308) at the root of
// Field.inv's product tree (:320), a fori_loop of 255 squarings and
// multiplies.  As torch ops one inversion would be about 510 FQ.mul calls
// of a dozen launches each.  On the card the port's Field.inv hands every
// lane to this kernel in one launch (every to_affine, and FR.inv of each
// round's challenge in the device-transcript open): the lanes run side by
// side, so the launch costs about what the tree's root alone would, and
// the tree's 2 lg n levels of multiplies in torch ops are gone; inv makes
// no host copy.
//
// One lane per thread: load into 8 words (field.cuh, the modulus a
// template parameter), then left-to-right square-and-multiply over the
// constant exponent p - 2 = 2^254 + (c - 2), from its top bit: 254
// squarings and popcount(p - 2) - 1 multiplies (76 for Fq, 73 for Fr),
// the branch uniform across the warp; store canonical limbs.  The open's
// rounds invert one or two lanes a launch, so a launch is latency-bound:
// each thread runs a chain of 330 dependent multiplies.  Bound on the
// H100 (least work): 254 squarings at 60 32-bit products and the
// multiplies at 88, over 132 SMs x 64 IMAD a clock; at a few lanes the
// chain's latency, not that rate, is what the card cannot beat
// (chip_smoke.py reports both).  Left for later: one inversion split
// across threads, as padd splits an add.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

// word j of p - 2: word 0 of p is 1, so it borrows from word 1 (c's word 1
// is not 0)
template <class M>
__device__ __forceinline__ uint32_t exp_word(int j) {
  return j == 0 ? 0xFFFFFFFFu : j == 1 ? M::q_word(1) - 1u : M::q_word(j);
}

template <class M>
__device__ __forceinline__ halo::Fe fermat_inv(const halo::Fe& a) {
  halo::Fe acc = a;  // bit 254, the top bit of p - 2
#pragma unroll
  for (int j = halo::NW - 1; j >= 0; --j) {
    const uint32_t w = exp_word<M>(j);
#pragma unroll 1
    for (int b = (j == halo::NW - 1 ? 29 : 31); b >= 0; --b) {
      halo::Fe s;
      halo::fe_mul<M>(acc.v, acc.v, s.v);
      if ((w >> b) & 1u) {
        halo::fe_mul<M>(s.v, a.v, acc.v);
      } else {
        acc = s;
      }
    }
  }
  return acc;
}

template <class M>
__global__ void finv_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ o, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  halo::store_fe<M>(o, n, i, fermat_inv<M>(halo::load_fe<M>(a, n, i)));
}

constexpr int kThreads = 128;

}  // namespace

// field: 0 for Fq, 1 for Fr
extern "C" int halo_finv(const void* a, void* o, int64_t n, int field, void* stream) {
  if (field != 0 && field != 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (field == 0) {
      finv_kernel<halo::Fq><<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int64_t*)a, (int64_t*)o, n);
    } else {
      finv_kernel<halo::Fr><<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int64_t*)a, (int64_t*)o, n);
    }
  }
  return (int)cudaGetLastError();
}
