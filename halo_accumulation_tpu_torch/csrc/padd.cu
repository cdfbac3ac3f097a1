// padd: complete projective point addition, 2 x 3 x (18, n) -> 3 x (18, n).
//
// Replaces the TPU kernel _padd_kernel / _padd_call in
// halo_accumulation_tpu/ops/pallas_kernels.py (RCB16 algorithm 7, a = 0,
// b3 = 15; the list-form formulas of ops/limbs.py padd_list).  On the card
// every curve.padd goes here: the msm_rows tables and tree sums, the suffix
// weighting's shifted adds, the Horner window combine and the URS sums.
//
// Boundary: int64 limb planes, loaded into 8-word field elements and stored
// as canonical limbs (field.cuh).  An add is 12 multiplies, 2 small
// multiplies, 5 subs and a few adds.  Most launches are narrow (1 to 2
// lanes in the prover's Horner combines, 10 to 30 in the verifiers', the
// row MSMs at their batch width), where the time is the serial latency of
// one lane's chain, not the card's multiply rate.
// The 12 multiplies form two levels of 6 independent ones (x1 x2, y1 y2,
// z1 z2 and the three cross sums; then t3 t1b, t4 wb, t1b z3s, wb t0b,
// z3s t4, t0b t3), so six threads of one warp share a lane (five lanes a
// warp, 30 of its 32 threads):
//   level A  thread r runs one whole halo::mul on operand pair r (threads
//            3 to 5 first add the two coordinates of their cross sum);
//   middle   thread r computes one of t3, t4, wb, t1b, z3s, t0b from the
//            six products, in three steps that every thread takes in the
//            same order (a small multiply or an add; a sub or an add; the
//            small multiply of w on thread 2), so a warp runs about five
//            small operations here instead of the whole section;
//   level C  thread r runs one halo::mul on two of those six values;
//   output   threads 0, 1, 2 each form and store one coordinate.
// Products and middle values meet in shared memory under __syncwarp; a
// lane's threads never straddle a warp.  The multiply depth of an add falls
// from 12 to 2: on the H100 the split add takes 6.6 to 7.3 us a launch at 1
// to 30 lanes.  Eight threads a lane (four lanes a warp), the middle
// run by every thread alike, and one thread per lane (faster only at widths
// no path launches) were measured and removed (PERF.md).  Every
// product, small multiply, sub and add is the same field operation on the
// same operands as in the plain twin, so the stored limbs equal the
// canonical form of the twin's.
#include <cuda_runtime.h>
#define HALO_INLINE_FIELD_OPS  // one or two of each field op a thread: inline them
#include "curve.cuh"

namespace {

using halo::Fe;

constexpr int kGroup = 6;                // threads per lane, one per product of a level
constexpr int kPerWarp = 32 / kGroup;    // 5 lanes a warp
constexpr int kWarps = 4;                // warps per block
constexpr int kLanes = kWarps * kPerWarp;
constexpr unsigned kMask = 0xFFFFFFFFu >> (32 - kGroup * kPerWarp);  // the threads of whole lanes

// Six field elements per lane of the block: buf[m][word][lane].
using Buf = uint32_t[kGroup][halo::NW][kLanes];

__device__ __forceinline__ void put_fe(Buf& buf, int m, int li, const Fe& a) {
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) buf[m][i][li] = a.v[i];
}

__device__ __forceinline__ Fe get_fe(const Buf& buf, int m, int li) {
  Fe a;
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) a.v[i] = buf[m][i][li];
  return a;
}

// Entry r of a table of six small numbers packed four bits each, entry 0
// lowest: the per-thread operand choices below, without a local array.
__device__ __forceinline__ int nib(uint32_t table, int r) { return (table >> (4 * r)) & 0xF; }

__device__ __forceinline__ const int64_t* coord(int c, const int64_t* x, const int64_t* y,
                                                const int64_t* z) {
  return c == 0 ? x : (c == 1 ? y : z);
}

__global__ void __launch_bounds__(32 * kWarps)
    padd_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                      const int64_t* __restrict__ z1, const int64_t* __restrict__ x2,
                      const int64_t* __restrict__ y2, const int64_t* __restrict__ z2,
                      int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                      int64_t* __restrict__ oz, int64_t n) {
  __shared__ Buf A, B;
  const int t = threadIdx.x % 32;
  if (t >= kGroup * kPerWarp) return;  // outside kMask: takes no part in the exchange
  const int li = (threadIdx.x / 32) * kPerWarp + t / kGroup, r = t % kGroup;
  const int64_t i = (int64_t)blockIdx.x * kLanes + li;
  const bool on = i < n;  // a lane past n only keeps its warp's step

  // level A, product r (A slots): 0 t0 = x1 x2, 1 t1 = y1 y2, 2 t2 = z1 z2,
  // 3 m3 = (x1 + y1)(x2 + y2), 4 m4 = (y1 + z1)(y2 + z2),
  // 5 m5 = (x1 + z1)(x2 + z2)
  if (on) {
    const int c0 = nib(0x010210u, r), c1 = nib(0x221000u, r);
    Fe a = halo::load_fe(coord(c0, x1, y1, z1), n, i);
    Fe b = halo::load_fe(coord(c0, x2, y2, z2), n, i);
    if (r >= 3) {
      a = halo::add(a, halo::load_fe(coord(c1, x1, y1, z1), n, i));
      b = halo::add(b, halo::load_fe(coord(c1, x2, y2, z2), n, i));
    }
    put_fe(A, r, li, halo::mul(a, b));
  }
  __syncwarp(kMask);

  // middle, value r (B slots): 0 t3 = m3 - (t0 + t1), 1 t4 = m4 - (t1 + t2),
  // 2 wb = 15 (m5 - (t0 + t2)), 3 t1b = t1 - 15 t2, 4 z3s = t1 + 15 t2,
  // 5 t0b = (t0 + t0) + t0
  if (on) {
    const Fe u = (r == 3 || r == 4)
                     ? halo::mul_small(get_fe(A, 2, li), 15u)
                     : halo::add(get_fe(A, nib(0x000010u, r), li), get_fe(A, nib(0x000221u, r), li));
    const Fe d = get_fe(A, nib(0x011543u, r), li);
    Fe v = r < 4 ? halo::sub(d, u) : halo::add(d, u);
    if (r == 2) v = halo::mul_small(v, 15u);
    put_fe(B, r, li, v);
  }
  __syncwarp(kMask);

  // level C, product r (A slots again: every read of level A came before
  // the last exchange): 0 t3 t1b, 1 t4 wb, 2 t1b z3s, 3 wb t0b, 4 z3s t4,
  // 5 t0b t3
  if (on) put_fe(A, r, li, halo::mul(get_fe(B, nib(0x542310u, r), li), get_fe(B, nib(0x015423u, r), li)));
  __syncwarp(kMask);

  // output coordinate r from products 2r and 2r + 1: x3 = t3 t1b - t4 wb,
  // y3 = t1b z3s + wb t0b, z3 = z3s t4 + t0b t3
  if (on && r < 3) {
    const Fe p = get_fe(A, 2 * r, li), q = get_fe(A, 2 * r + 1, li);
    halo::store_fe(r == 0 ? ox : (r == 1 ? oy : oz), n, i, r == 0 ? halo::sub(p, q) : halo::add(p, q));
  }
}

}  // namespace

extern "C" int halo_padd(const void* x1, const void* y1, const void* z1, const void* x2,
                         const void* y2, const void* z2, void* ox, void* oy, void* oz,
                         int64_t n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kLanes - 1) / kLanes);
    padd_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x1, (const int64_t*)y1, (const int64_t*)z1, (const int64_t*)x2,
        (const int64_t*)y2, (const int64_t*)z2, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz, n);
  }
  return (int)cudaGetLastError();
}
