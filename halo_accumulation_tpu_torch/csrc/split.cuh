// A column's pad slots split across T threads, and the tree that combines
// their partial sums (bucket_masked.cu, bucket_accum.cu).
//
// A block holds cb = blockDim.x / T columns; thread t works on column
// x = t % cb (the column varies fastest, so the threads of one chunk index
// read adjacent columns of a slot plane) and owns chunk j = t / cb of it.
// Each thread first sums its chunk from the identity in registers; then the
// T partials meet in a fixed binary tree in shared memory: at level s,
// partial j += partial j + 2^s for j a multiple of 2^(s+1), skipped where
// chunk j + 2^s is empty (chunks are contiguous, so all after it are empty
// too).  A partial crosses shared memory as 3 x 8 words.  T = 1 runs no
// level: one ordered sum per column.
#pragma once
#include "curve.cuh"

namespace halo {

constexpr int kSplitMax = 16;    // the most threads a column
constexpr int kSplitBlock = 256;  // threads of a block at T >= 8

// Threads of a block for T threads a column: 32 columns up to T = 8, 16 at
// T = 16.
inline int split_block(int T) { return T >= 8 ? kSplitBlock : 32 * T; }

inline bool split_ok(int T) { return T >= 1 && T <= kSplitMax && (T & (T - 1)) == 0; }

// Slot s of the tree holds the partial of chunk 2 s or 2 s + 1 (odd
// multiples of 2^h write at level h) of block column x at s * cb + x; word
// w of it at part[w][slot].
using SplitBuf = uint32_t[3 * NW][kSplitBlock / 2];

__device__ __forceinline__ void put_pt(SplitBuf& part, int s, const Pt& P) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    part[i][s] = P.x.v[i];
    part[NW + i][s] = P.y.v[i];
    part[2 * NW + i][s] = P.z.v[i];
  }
}

__device__ __forceinline__ Pt get_pt(const SplitBuf& part, int s) {
  Pt P;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    P.x.v[i] = part[i][s];
    P.y.v[i] = part[NW + i][s];
    P.z.v[i] = part[2 * NW + i][s];
  }
  return P;
}

// Thread (x, j)'s partial acc combined over the tree; thread j == 0 returns
// its column's sum.  nonempty(k): chunk k of this thread's column holds a
// slot.  Every thread of the block calls this (it holds __syncthreads).
template <class NonEmpty>
__device__ __forceinline__ Pt combine_split(Pt acc, SplitBuf& part, int x, int j, int cb, int T,
                                            NonEmpty nonempty) {
  for (int h = 1; h < T; h <<= 1) {
    __syncthreads();  // the last level's reads are done
    if ((j & (2 * h - 1)) == h) put_pt(part, (j >> 1) * cb + x, acc);
    __syncthreads();
    if ((j & (2 * h - 1)) == 0 && nonempty(j + h)) acc = padd(acc, get_pt(part, ((j + h) >> 1) * cb + x));
  }
  return acc;
}

}  // namespace halo
