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
// unchanged.  The T partial sums then meet in a fixed binary tree in shared
// memory: at level s, partial j += partial j + 2^s for j a multiple of
// 2^(s+1), skipped where chunk j + 2^s and all after it are empty.  So a
// dead column adds nothing and stays exactly (0 : 1 : 0), and T = 1 is the
// one-thread-per-column loop of the first port.  The plain twin in
// ops/cuda_kernels.py follows the same chunks and the same tree, so the two
// agree limb for limb.
//
// Thread layout: the column varies fastest, so the threads of one chunk
// index read adjacent columns of a slot plane (coalesced).  Blocks are
// 32 T threads (32 columns) up to T = 8 and 256 threads (16 columns) at
// T = 16.  Each column's chunks are sized by its own len, so a warp runs to
// the longest chunk of its columns, not to the longest column.
//
// Boundary: int64 planes (packed pairs are < 2^30).  Bound on the H100:
// integer multiply-add issue of the adds, and residency: at one thread per
// column the n = 16384 decider's 7936 columns made 248 one-warp blocks for
// 132 SMs; split 8 ways they make 248 blocks of 8 warps, about one resident
// wave at 255 registers a thread.  __launch_bounds__(kBlock, 1) lets a
// thread keep 255 registers: a cap of 128 (two blocks an SM) spilled about
// 3.5 KB a thread and ran 10 to 24 % slower on the H100 (PERF.md, PR 4).
// Left for later: the same split for bucket_accum, and the limb work noted
// in fmul.cu.
#include <cuda_runtime.h>
#include "curve.cuh"

namespace {

constexpr int kMaxSplit = 16;
constexpr int kBlock = 256;  // threads of a block at T >= 8

__device__ __forceinline__ halo::Pt load_slot(const int64_t* __restrict__ M, int lanes,
                                              int64_t plane, int64_t base) {
  if (lanes != halo::L) {
    return halo::load_pt(M + base, M + halo::L * plane + base, M + 2 * halo::L * plane + base,
                         plane, 0);
  }
  halo::Pt S;
#pragma unroll
  for (int k = 0; k < halo::L; ++k) {
    const uint32_t v = (uint32_t)M[k * plane + base];
    const uint32_t lo = v & halo::M15, hi = (v >> 15) & halo::M15;
    // limbs 2k and 2k + 1 of x || y
    if (2 * k < halo::L) S.x.v[2 * k] = lo; else S.y.v[2 * k - halo::L] = lo;
    if (2 * k + 1 < halo::L) S.x.v[2 * k + 1] = hi; else S.y.v[2 * k + 1 - halo::L] = hi;
    S.z.v[k] = k == 0 ? 1u : 0u;
  }
  return S;
}

// A partial sum in shared memory: word w of slot s at part[w][s].
__device__ __forceinline__ void put_pt(uint32_t (*part)[kBlock / 2], int s, const halo::Pt& P) {
#pragma unroll
  for (int i = 0; i < halo::L; ++i) {
    part[i][s] = P.x.v[i];
    part[halo::L + i][s] = P.y.v[i];
    part[2 * halo::L + i][s] = P.z.v[i];
  }
}

__device__ __forceinline__ halo::Pt get_pt(uint32_t (*part)[kBlock / 2], int s) {
  halo::Pt P;
#pragma unroll
  for (int i = 0; i < halo::L; ++i) {
    P.x.v[i] = part[i][s];
    P.y.v[i] = part[halo::L + i][s];
    P.z.v[i] = part[2 * halo::L + i][s];
  }
  return P;
}

__global__ void __launch_bounds__(kBlock, 1)
    bucket_masked_kernel(const int64_t* __restrict__ M, const int64_t* __restrict__ meta,
                         int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                         int64_t* __restrict__ oz, int lanes, int64_t padp, int64_t cols,
                         int T) {
  // slot s of the tree holds the partial of chunk 2 s or 2 s + 1 (odd
  // multiples of 2^s write at level s) of block column x at s * cb + x
  __shared__ uint32_t part[3 * halo::L][kBlock / 2];
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
  for (int h = 1; h < T; h <<= 1) {
    __syncthreads();  // the last level's reads are done
    if ((j & (2 * h - 1)) == h) put_pt(part, (j >> 1) * cb + x, acc);
    __syncthreads();
    if ((j & (2 * h - 1)) == 0 && off + (j + h) * q < end)
      acc = halo::padd(acc, get_pt(part, ((j + h) >> 1) * cb + x));
  }
  if (j == 0 && live) halo::store_pt(ox, oy, oz, cols, col, acc);
}

}  // namespace

extern "C" int halo_bucket_masked(const void* M, const void* meta, void* ox, void* oy,
                                  void* oz, int lanes, int64_t padp, int64_t cols, int T,
                                  void* stream) {
  if (T < 1 || T > kMaxSplit || (T & (T - 1)) != 0 || (lanes != halo::L && lanes != 3 * halo::L))
    return (int)cudaErrorInvalidValue;
  if (cols > 0) {
    const int threads = T >= 8 ? kBlock : 32 * T;
    const int64_t cb = threads / T;
    const unsigned blocks = (unsigned)((cols + cb - 1) / cb);
    bucket_masked_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)M, (const int64_t*)meta, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        lanes, padp, cols, T);
  }
  return (int)cudaGetLastError();
}
