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
// accumulator and added the identity for dead slots.  Here one thread owns
// one column, keeps the accumulator in registers, and loops over its live
// slots only: a dead slot leaves the sum's value unchanged, and skipping it
// saves the add (a warp still runs from its lowest off to its highest
// off + len).  The plain twin in ops/cuda_kernels.py skips the same slots,
// so the two agree limb for limb.
//
// Boundary: int64 planes (packed pairs are < 2^30).  Bound on the H100:
// integer multiply-add issue of the ~len sequential adds per column, and
// occupancy: the n = 16384 verify_chain decider has 7936 columns, so blocks
// are one warp each (248 blocks for 132 SMs).  Left for later: splitting a
// column's slots across threads with a tree combine to fill the card, and
// the limb work noted in fmul.cu.
#include <cuda_runtime.h>
#include "curve.cuh"

__global__ void bucket_masked_kernel(const int64_t* __restrict__ M,
                                     const int64_t* __restrict__ meta,
                                     int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                     int64_t* __restrict__ oz, int lanes, int64_t padp,
                                     int64_t cols) {
  int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const uint64_t m = (uint64_t)meta[col];
  const int64_t off = (int64_t)(m & 7u);
  int64_t end = off + (int64_t)(m >> 3);
  if (end > padp) end = padp;
  const int64_t plane = padp * cols;  // stride between lanes of M
  halo::Pt acc = halo::identity();
  for (int64_t p = off; p < end; ++p) {
    const int64_t base = p * cols + col;
    halo::Pt S;
    if (lanes == halo::L) {
#pragma unroll
      for (int k = 0; k < halo::L; ++k) {
        const uint32_t v = (uint32_t)M[k * plane + base];
        const uint32_t lo = v & halo::M15, hi = (v >> 15) & halo::M15;
        // limbs 2k and 2k + 1 of x || y
        if (2 * k < halo::L) S.x.v[2 * k] = lo; else S.y.v[2 * k - halo::L] = lo;
        if (2 * k + 1 < halo::L) S.x.v[2 * k + 1] = hi; else S.y.v[2 * k + 1 - halo::L] = hi;
        S.z.v[k] = k == 0 ? 1u : 0u;
      }
    } else {
      S = halo::load_pt(M + base, M + halo::L * plane + base, M + 2 * halo::L * plane + base,
                        plane, 0);
    }
    acc = halo::padd(acc, S);
  }
  halo::store_pt(ox, oy, oz, cols, col, acc);
}

extern "C" int halo_bucket_masked(const void* M, const void* meta, void* ox, void* oy,
                                  void* oz, int lanes, int64_t padp, int64_t cols,
                                  void* stream) {
  if (cols > 0) {
    const int threads = 32;
    const unsigned blocks = (unsigned)((cols + threads - 1) / threads);
    bucket_masked_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)M, (const int64_t*)meta, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        lanes, padp, cols);
  }
  return (int)cudaGetLastError();
}
