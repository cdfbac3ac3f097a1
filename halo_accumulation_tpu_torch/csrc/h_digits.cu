// h_digits: the deciders' h(X) coefficients, cut straight into their MSM
// window digits.  xis (18, K, lg + 1) Fr limbs -> (W K, 2^lg) int64 digits.
//
// No Pallas counterpart: in the JAX package this is XLA glue, the h
// expansion vmap(tensor_h_coeffs) of _deciders_fused
// (halo_accumulation_tpu/acc.py:244) and the window digits its sort-payload
// MSM cuts from the coefficients.  The port ran the same glue as torch ops
// (poly.tensor_h_coeffs, then msm._digits): 14 rounds of FR.mul on 15-bit
// limb planes and FR.canon, about 2,200 ops and 20 GB of device traffic a
// chunk of ten claims at n = 2^14, for an output of 42 MB.
//
// Claim k's coefficient j is the product of xi_{lg - i} over the set bits i
// of j (xis[k, 0] is not a factor), reduced to its canonical value mod r.
// Output row w K + k, column j, holds that value's c-bit window W - 1 - w
// (msb window first): msm._digits' cut, W = ceil(255 / c) windows, laid out
// as msm.msm_many_flagged stacks its digit rows.  c is a template
// parameter (4, 6, 8, 10 and 12, the sizes msm.window_size picks), so the
// window loop unrolls and the value's words stay in registers.
//
// A block takes one claim and a tile of 2^t consecutive coefficients (t =
// min(lg, 8)), a thread each.  Bits 0 .. t - 1 of j index the tile: the
// block builds the 2^t products of those low factors in shared memory by
// doubling, as tensor_h_coeffs does (round i: entry 2^i + u = entry u times
// the factor of bit i; 2^t - 1 multiplies a block).  Meanwhile its last
// thread, idle in every round, multiplies the factors of the tile's high
// bits t .. lg - 1.  Then each thread takes one multiply, low times high,
// makes the value canonical and writes its W digits: neighbouring threads
// on neighbouring columns of each row, so every row's stores coalesce.
// Field multiplication is exact, so this order of factors gives the
// canonical value of the twin's.  Arithmetic on halo::Fr (field.cuh), 8 x
// 32-bit words.
//
// Bound: the digit writes, 8 W K 2^lg bytes (42 MB at the decider's K =
// 10, n = 2^14, c = 8: 12.5 us at 3.35 TB/s).  The least multiplies, 2^lg -
// 1 a claim at 88 32-bit operations each, take 0.9 us there.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

using halo::Fe;
using halo::NW;

constexpr int kTileBits = 8;  // 2^8 coefficients a block, one a thread
constexpr int kMaxLg = 30;    // challenges a claim: 2^lg columns a row

__device__ __forceinline__ Fe fr_mul(const Fe& a, const Fe& b) {
  Fe r;
  halo::fe_mul<halo::Fr>(a.v, b.v, r.v);
  return r;
}

// Shared values word-major (word i of entry u at [i][u]), so a warp's
// accesses fall on distinct banks.
template <int N>
__device__ __forceinline__ Fe get(const uint32_t (&s)[NW][N], int u) {
  Fe a;
#pragma unroll
  for (int i = 0; i < NW; ++i) a.v[i] = s[i][u];
  return a;
}

template <int N>
__device__ __forceinline__ void put(uint32_t (&s)[NW][N], int u, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) s[i][u] = a.v[i];
}

// The canonical words of a (V < 2^255 < 2r: subtract r unless that
// borrows), with a zero word on top for the digit cut.
__device__ __forceinline__ void canon_words(const Fe& a, uint32_t (&w)[NW + 1]) {
  uint32_t d[NW];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (int64_t)a.v[i] - (int64_t)halo::Fr::q_word(i);
    d[i] = (uint32_t)acc;
    acc >>= 32;
  }
  const bool lt = acc < 0;  // V < r
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = lt ? a.v[i] : d[i];
  w[NW] = 0;
}

template <int C>
__global__ void __launch_bounds__(1 << kTileBits)
    h_digits_kernel(const int64_t* __restrict__ xis, int64_t* __restrict__ out, int64_t K, int lg, int t) {
  constexpr int W = (255 + C - 1) / C;
  __shared__ uint32_t fac[NW][kMaxLg];             // the factor of bit i of j
  __shared__ uint32_t tab[NW][1 << kTileBits];     // the tile's low products
  __shared__ uint32_t high[NW][1];                 // the tile's high product
  const int u = threadIdx.x;
  const int64_t k = blockIdx.y, tile = blockIdx.x;
  const int64_t m = lg + 1;  // challenges a claim
  for (int i = u; i < lg; i += blockDim.x) put(fac, i, halo::load_fe<halo::Fr>(xis, K * m, k * m + lg - i));
  if (u == 0) put(tab, 0, halo::fe_word(1));
  __syncthreads();
  if (u == (int)blockDim.x - 1) {
    Fe h = halo::fe_word(1);
    for (int i = t; i < lg; ++i)
      if ((tile >> (i - t)) & 1) h = fr_mul(h, get(fac, i));
    put(high, 0, h);
  }
  for (int i = 0; i < t; ++i) {
    const int h = 1 << i;
    if (u < h) put(tab, h + u, fr_mul(get(tab, u), get(fac, i)));
    __syncthreads();
  }
  __syncthreads();
  uint32_t w[NW + 1];
  canon_words(fr_mul(get(tab, u), get(high, 0)), w);
  const int64_t n = (int64_t)1 << lg;
  int64_t* col = out + k * n + (tile << t) + u;
#pragma unroll
  for (int b = 0; b < W; ++b) {  // bits C b .. C b + C - 1: row (W - 1 - b) K + k
    const int j = (C * b) / 32, off = (C * b) % 32;
    const uint64_t pair = ((uint64_t)w[j + 1] << 32) | w[j];
    col[(W - 1 - b) * K * n] = (int64_t)((pair >> off) & ((1u << C) - 1));
  }
}

template <int C>
void launch(const int64_t* xis, int64_t* out, int64_t K, int lg, cudaStream_t stream) {
  const int t = lg < kTileBits ? lg : kTileBits;
  const dim3 grid((unsigned)(((int64_t)1 << lg) >> t), (unsigned)K);
  h_digits_kernel<C><<<grid, 1 << t, 0, stream>>>(xis, out, K, lg, t);
}

}  // namespace

// xis: (18, K, lg + 1) int64 limbs, contiguous; out: (W K, 2^lg) int64
extern "C" int halo_h_digits(const void* xis, void* out, int64_t K, int lg, int c, void* stream) {
  if (lg < 0 || lg > kMaxLg || K < 0 || K > 65535) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const int64_t* x = (const int64_t*)xis;
  int64_t* o = (int64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 4: launch<4>(x, o, K, lg, s); break;
    case 6: launch<6>(x, o, K, lg, s); break;
    case 8: launch<8>(x, o, K, lg, s); break;
    case 10: launch<10>(x, o, K, lg, s); break;
    case 12: launch<12>(x, o, K, lg, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
