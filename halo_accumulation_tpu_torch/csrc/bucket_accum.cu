// bucket_accum: pad-axis bucket sums of the row-permutation MSM.
//
// Replaces the TPU kernels _bucket_kernel_aff and _bucket_kernel_proj
// (_bucket_call / bucket_accum) in halo_accumulation_tpu/ops/pallas_kernels.py.
// Input: a row table rows (nrows, lanes) and an inverse permutation src
// (pad, cols) of row indices.  For every column the kernel sums the rows
// src[0, col], ..., src[pad - 1, col] with complete adds, every slot
// included: the sentinel row (the table's last) decodes as the identity,
// and adding it still changes the projective representative, so slots are
// not skipped.
//   lanes == 40: affine x || y || Z-indicator || pad; Z = (row[36], 0, ...),
//                1 for real points, 0 for the sentinel (whose y0 is 1).
//   lanes == 64: projective x || y || z || pad.
//
// The TPU gathered and transposed the whole (lanes, pad, cols) matrix in
// HBM and ran the pad axis as a sequential grid axis over a VMEM-resident
// accumulator.  Here each thread gathers its own rows, so the gathered
// matrix is never written (at the n = 16384 main group, 7936 columns x 128
// slots, it would be 325 MB of int64 affine rows or 520 MB of projective
// ones per MSM), and T threads share a column (split.cuh; T a power of two,
// 1..16, chosen from the shapes alone by ops/cuda_kernels.accum_split).
// With q = ceil(pad / T), thread j sums chunk j = [j q, min((j + 1) q, pad))
// from (0 : 1 : 0) in increasing p, every slot of it; the T partials then
// meet in split.cuh's tree.  T = 1 is the Pallas kernels' order (initialise
// at p == 0, then add each slot).  The plain twin in ops/cuda_kernels.py
// follows the same chunks and the same tree, so the kernel's canonical
// limbs equal FQ.canon of the twin's at every T.
//
// Each row is loaded into 8-word field elements (field.cuh) as it is
// gathered, and the sums are stored as canonical limbs.  Bound on the H100:
// integer multiply-add issue of the pad sequential adds, and occupancy: at
// one thread a column the main group's 7936 columns made 248 one-warp
// blocks for 132 SMs, and the folded top window's 1024 columns only 32;
// split T ways, a column's chain of adds is T times shorter and the card
// holds T times the warps.  At the main group T = 4 (134 registers, no
// spills) takes 0.54 to 0.62 ms against 1.41 to 1.52 ms at T = 1 on the
// H100 (PERF.md).
#include <cuda_runtime.h>
#include "split.cuh"

namespace {

__device__ __forceinline__ halo::Pt load_row(const int64_t* __restrict__ row, int lanes) {
  return halo::Pt{halo::load_fe(row, 1, 0), halo::load_fe(row + halo::L, 1, 0),
                  lanes == 64 ? halo::load_fe(row + 2 * halo::L, 1, 0)
                              : halo::fe_word((uint32_t)row[2 * halo::L])};
}

__global__ void __launch_bounds__(halo::kSplitBlock, 1)
    bucket_accum_kernel(const int64_t* __restrict__ rows, const int64_t* __restrict__ src,
                        int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                        int64_t* __restrict__ oz, int lanes, int64_t pad, int64_t cols, int T) {
  __shared__ halo::SplitBuf part;
  const int cb = blockDim.x / T;  // columns per block
  const int x = threadIdx.x % cb, j = threadIdx.x / cb;
  const int64_t col = (int64_t)blockIdx.x * cb + x;
  const bool live = col < cols;
  const int64_t q = (pad + T - 1) / T;
  const int64_t start = j * q;
  const int64_t stop = !live ? start : (start + q < pad ? start + q : pad);
  halo::Pt acc = halo::identity();
  for (int64_t p = start; p < stop; ++p) acc = halo::padd(acc, load_row(rows + src[p * cols + col] * lanes, lanes));
  acc = halo::combine_split(acc, part, x, j, cb, T, [&](int k) { return k * q < pad; });
  if (j == 0 && live) halo::store_pt(ox, oy, oz, cols, col, acc);
}

}  // namespace

extern "C" int halo_bucket_accum(const void* rows, const void* src, void* ox, void* oy, void* oz,
                                 int lanes, int64_t pad, int64_t cols, int T, void* stream) {
  if (!halo::split_ok(T) || (lanes != 40 && lanes != 64)) return (int)cudaErrorInvalidValue;
  if (cols > 0) {
    const int threads = halo::split_block(T);
    const int64_t cb = threads / T;
    const unsigned blocks = (unsigned)((cols + cb - 1) / cb);
    bucket_accum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)rows, (const int64_t*)src, (int64_t*)ox, (int64_t*)oy, (int64_t*)oz,
        lanes, pad, cols, T);
  }
  return (int)cudaGetLastError();
}
