// pdbl: k complete projective point doublings, 3 x (18, n) -> 3 x (18, n).
//
// Replaces the TPU kernel _pdbl_kernel / _pdbl_call in
// halo_accumulation_tpu/ops/pallas_kernels.py (RCB16 algorithm 9, a = 0;
// ops/limbs.py pdbl_list).  On the card every curve.pdbl goes here: the
// msm_rows windows (k = 4) and the Horner window combine (k = c).  The k
// doublings run in registers, with one load and one store per lane, so a
// window costs one launch instead of k.
//
// Boundary: int64 limb planes, loaded into 8-word field elements and stored
// as canonical limbs (field.cuh).  A double is 8 multiplies, 3 small
// multiplies, a sub and 3 adds.  The paths run it narrow (the Horner
// combine at 1 to 30 lanes, the row MSMs at their batch width), where the
// time is the serial latency of one thread.
// The 8 multiplies of a double form two levels of 4 independent ones (y y,
// y z, z z, x y; then t2 z38, t1 z38, t0a y3s, t0a xy), so four threads of
// one warp share a lane: each runs one whole halo::mul per level on its own
// operands and the four 8-word products meet in shared memory.  The small
// multiplies, the sub and the adds are run by all four threads alike (no
// divergence).  The multiply depth of a double falls from 8 to 2: on the
// H100 a double takes 2.1 to 2.2 us at 1 to 1,024 lanes; one thread
// per lane, faster only from 32,768 lanes, a width no path launches, was
// measured and removed (PERF.md).  Every multiply is the same
// halo::mul on the same operands as in the twin, so the stored limbs equal
// the canonical form of the twin's.
#include <cuda_runtime.h>
#define HALO_INLINE_FIELD_OPS  // one or two of each field op a thread: inline them
#include "curve.cuh"

namespace {

constexpr int kGroup = 4;          // threads per lane
constexpr int kBlock = 128;        // 32 lanes of 4 threads
constexpr int kLanes = kBlock / kGroup;

__device__ __forceinline__ halo::Fe pick(int r, const halo::Fe& a0, const halo::Fe& a1,
                                         const halo::Fe& a2, const halo::Fe& a3) {
  halo::Fe o;
#pragma unroll
  for (int i = 0; i < halo::NW; ++i)
    o.v[i] = r == 0 ? a0.v[i] : (r == 1 ? a1.v[i] : (r == 2 ? a2.v[i] : a3.v[i]));
  return o;
}

// The four products of one level: buf[m][word][lane of the block].
using Buf = uint32_t[kGroup][halo::NW][kLanes];

__device__ __forceinline__ void put_fe(Buf& buf, int m, int li, const halo::Fe& a) {
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) buf[m][i][li] = a.v[i];
}

__device__ __forceinline__ halo::Fe get_fe(const Buf& buf, int m, int li) {
  halo::Fe a;
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) a.v[i] = buf[m][i][li];
  return a;
}

__global__ void __launch_bounds__(kBlock)
    pdbl_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t n, int k) {
  __shared__ Buf buf;
  // the four threads of a lane are adjacent in one warp: __syncwarp orders
  // their shared-memory exchange, and no thread leaves early
  const int li = threadIdx.x / kGroup, r = threadIdx.x % kGroup;
  const int64_t i = (int64_t)blockIdx.x * kLanes + li;
  const bool live = i < n;
  halo::Pt P = live ? halo::load_pt(x, y, z, n, i) : halo::identity();
  for (int s = 0; s < k; ++s) {
    // level 1: t0 = y y, t1 = y z, zz = z z, xy = x y
    put_fe(buf, r, li, halo::mul(pick(r, P.y, P.y, P.z, P.x), pick(r, P.y, P.z, P.z, P.y)));
    __syncwarp();
    const halo::Fe t0 = get_fe(buf, 0, li), t1 = get_fe(buf, 1, li);
    const halo::Fe zz = get_fe(buf, 2, li), xy = get_fe(buf, 3, li);
    __syncwarp();
    const halo::Fe t2 = halo::mul_small(zz, 15u);
    const halo::Fe z38 = halo::mul_small(t0, 8u);
    const halo::Fe y3s = halo::add(t0, t2);
    const halo::Fe t0a = halo::sub(t0, halo::mul_small(t2, 3u));
    // level 2: x3a = t2 z38, z3 = t1 z38, y3b = t0a y3s, x3b = t0a xy
    put_fe(buf, r, li, halo::mul(pick(r, t2, t1, t0a, t0a), pick(r, z38, z38, y3s, xy)));
    __syncwarp();
    const halo::Fe x3a = get_fe(buf, 0, li), y3b = get_fe(buf, 2, li), x3b = get_fe(buf, 3, li);
    P.z = get_fe(buf, 1, li);
    __syncwarp();
    P.y = halo::add(x3a, y3b);
    P.x = halo::add(x3b, x3b);
  }
  if (live && r == 0) halo::store_pt(ox, oy, oz, n, i, P);
}

}  // namespace

extern "C" int halo_pdbl(const void* x, const void* y, const void* z, void* ox, void* oy,
                         void* oz, int64_t n, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kLanes - 1) / kLanes);
    pdbl_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)z, (int64_t*)ox, (int64_t*)oy,
        (int64_t*)oz, n, k);
  }
  return (int)cudaGetLastError();
}
