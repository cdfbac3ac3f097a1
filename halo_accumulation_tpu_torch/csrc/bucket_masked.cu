// bucket_masked: masked bucket reduction of the sort-payload MSM.
//
// Replaces the TPU kernel _bucket_kernel_masked / _bucket_masked_call in
// halo_accumulation_tpu/ops/pallas_kernels.py.  Input M (lanes, padp, cols)
// holds each column's points in digit order, gathered in 8-row blocks, and
// meta (cols) holds off | len << 3.  For every column the kernel sums the
// slots off <= p < off + len with complete adds, starting from (0 : 1 : 0).
// lanes == 18: pair-packed canonical affine x || y (plane k holds limbs 2k
// and 2k + 1 << 15), Z = 1 synthesized; lanes == 54: projective x || y || z.
//
// The TPU ran the pad axis as a sequential grid axis over a VMEM-resident
// accumulator and added the identity for dead slots.  Here T threads own one
// column (T a power of two, 1..16, chosen from the shapes alone by
// ops/cuda_kernels.bucket_split).  With q = ceil(len / T), thread j sums
// chunk j = [off + j q, min(off + (j + 1) q, end)) from the identity in
// increasing p, in registers; a dead slot is skipped, since it leaves a sum
// unchanged.  The T partial sums then meet in split.cuh's fixed binary
// tree, which skips empty chunks, so a dead column adds nothing and stays
// exactly (0 : 1 : 0), and T = 1 is the one-thread-per-column loop of the
// first port.  The plain twin in ops/cuda_kernels.py follows the same
// chunks and the same tree, so the kernel's canonical limbs equal FQ.canon
// of the twin's.  Each column's chunks are sized by its own len, so a warp
// runs to the longest chunk of its columns, not to the longest column.
//
// Boundary: int64 planes (packed pairs are < 2^30), loaded into 8-word field
// elements and stored as canonical limbs (field.cuh).  Bound on the H100:
// integer multiply-add issue of the adds, and residency: the kernel holds
// 154 registers a thread, so a 128-thread block (T = 4) fits three to an
// SM and a 256-thread one (T >= 8) one; the n = 16384 decider's 7936
// columns split 4 ways are one wave of 248 blocks, 8 to 15 % faster than
// 8 ways in two waves.  A cap of 128 registers (__launch_bounds__(256,
// 2)) sped T = 8 up by 6 to 11 % and decide_many's stacked fill by 2 to
// 3 %, but lost 8 to 21 % at T = 1 and left the best split of the other
// fills no faster, so the cap stays off (PERF.md).
#include <cuda_runtime.h>
#include "split.cuh"

namespace {

// Slot p of a column as a point: 18 lanes are packed affine x || y (plane
// k holds limbs 2k and 2k + 1, so x is planes 0 to 8 and y planes 9 to 17,
// 30 bits each), packed into words once here, with Z = 1; 54 lanes are
// projective x || y || z limbs.
__device__ __forceinline__ halo::Pt load_slot(const int64_t* __restrict__ M, int lanes,
                                              int64_t plane, int64_t base) {
  if (lanes != halo::L) {
    return halo::load_pt(M + base, M + halo::L * plane + base, M + 2 * halo::L * plane + base,
                         plane, 0);
  }
  constexpr int kHalf = halo::L / 2;
  uint32_t cx[kHalf], cy[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    cx[k] = (uint32_t)M[k * plane + base];
    cy[k] = (uint32_t)M[(kHalf + k) * plane + base];
  }
  return halo::Pt{halo::from_chunks<kHalf, 2 * 15>(cx), halo::from_chunks<kHalf, 2 * 15>(cy),
                  halo::fe_word(1)};
}

__global__ void __launch_bounds__(halo::kSplitBlock, 1)
    bucket_masked_kernel(const int64_t* __restrict__ M, const int64_t* __restrict__ meta,
                         int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, int lanes, int64_t padp, int64_t cols,
                         int T) {
  __shared__ halo::SplitBuf part;
  const int cb = blockDim.x / T;  // columns per block
  const int x = threadIdx.x % cb, j = threadIdx.x / cb;
  const int64_t col = (int64_t)blockIdx.x * cb + x;
  const bool live = col < cols;
  int64_t off = 0, end = 0, q = 0;
  if (live) {
    const uint64_t m = (uint64_t)meta[col];
    off = (int64_t)(m & 7u);
    end = off + (int64_t)(m >> 3);
    if (end > padp) end = padp;
    if (end > off) q = (end - off + T - 1) / T;
  }
  const int64_t plane = padp * cols;  // stride between lanes of M
  const int64_t start = off + j * q;
  const int64_t stop = start + q < end ? start + q : end;
  halo::Pt acc = halo::identity();
  for (int64_t p = start; p < stop; ++p) acc = halo::padd(acc, load_slot(M, lanes, plane, p * cols + col));
  acc = halo::combine_split(acc, part, x, j, cb, T, [&](int k) { return off + k * q < end; });
  if (j == 0 && live) halo::store_pt(ox, oy, oz, cols, col, acc);
}

}  // namespace

extern "C" int halo_bucket_masked(const void* M, const void* meta, void* ox, void* oy,
                                  void* oz, int lanes, int64_t padp, int64_t cols, int T,
                                  void* stream) {
  if (!halo::split_ok(T) || (lanes != halo::L && lanes != 3 * halo::L))
    return (int)cudaErrorInvalidValue;
  if (cols > 0) {
    const int threads = halo::split_block(T);
    const int64_t cb = threads / T;
    const unsigned blocks = (unsigned)((cols + cb - 1) / cb);
    bucket_masked_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)M, (const int64_t*)meta, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        lanes, padp, cols, T);
  }
  return (int)cudaGetLastError();
}
