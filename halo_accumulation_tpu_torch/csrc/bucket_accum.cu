// bucket_accum: pad-axis bucket sums of the row-permutation MSM.
//
// Replaces the TPU kernels _bucket_kernel_aff and _bucket_kernel_proj
// (_bucket_call / bucket_accum) in halo_accumulation_tpu/ops/pallas_kernels.py.
// Input: a row table rows (nrows, lanes) and an inverse permutation src
// (pad, cols) of row indices.  For every column the kernel sums the rows
// src[0, col], ..., src[pad - 1, col] with complete adds, starting from
// (0 : 1 : 0), every slot included: the sentinel row (the table's last)
// decodes as the identity, and adding it still changes the projective
// representative, so slots are not skipped.  This is the Pallas kernels'
// order (initialise at p == 0, then add each slot), and the plain twin in
// ops/cuda_kernels.py follows it, so the two agree limb for limb.
//   lanes == 40: affine x || y || Z-indicator || pad; Z = (row[36], 0, ...),
//                1 for real points, 0 for the sentinel (whose y0 is 1).
//   lanes == 64: projective x || y || z || pad.
//
// The TPU gathered and transposed the whole (lanes, pad, cols) matrix in
// HBM and ran the pad axis as a sequential grid axis over a VMEM-resident
// accumulator.  Here one thread owns one column, keeps the accumulator in
// registers, and gathers its own rows: the gathered matrix is never written
// (at the n = 16384 main group, 7936 columns x 128 slots, it would be 325 MB
// of int64 affine rows or 520 MB of projective ones per MSM).
//
// Bound on the H100: integer multiply-add issue of the pad sequential adds
// per column (8412 32-bit multiplies per add), and occupancy: 7936 columns
// are 248 one-warp blocks for 132 SMs, and the folded top window's 1024
// columns only 32.  Left for later: splitting the pad axis across threads
// with a tree combine, as for bucket_masked, and the limb work noted in
// fmul.cu.
#include <cuda_runtime.h>
#include "curve.cuh"

__global__ void bucket_accum_kernel(const int64_t* __restrict__ rows,
                                    const int64_t* __restrict__ src,
                                    int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                    int64_t* __restrict__ oz, int lanes, int64_t pad,
                                    int64_t cols) {
  int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  halo::Pt acc = halo::identity();
  for (int64_t p = 0; p < pad; ++p) {
    const int64_t* row = rows + src[p * cols + col] * lanes;
    halo::Pt S;
#pragma unroll
    for (int k = 0; k < halo::L; ++k) {
      S.x.v[k] = (uint32_t)row[k];
      S.y.v[k] = (uint32_t)row[halo::L + k];
      S.z.v[k] = (lanes == 64 || k == 0) ? (uint32_t)row[2 * halo::L + k] : 0u;
    }
    acc = halo::padd(acc, S);
  }
  halo::store_pt(ox, oy, oz, cols, col, acc);
}

extern "C" int halo_bucket_accum(const void* rows, const void* src, void* ox, void* oy, void* oz,
                                 int lanes, int64_t pad, int64_t cols, void* stream) {
  if (cols > 0) {
    const int threads = 32;
    const unsigned blocks = (unsigned)((cols + threads - 1) / threads);
    bucket_accum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)rows, (const int64_t*)src, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        lanes, pad, cols);
  }
  return (int)cudaGetLastError();
}
