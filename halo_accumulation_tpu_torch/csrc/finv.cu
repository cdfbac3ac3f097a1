// finv: batched inversion a^-1 mod p of (18, n) limb planes, over Fq or Fr
// (p = q or r), -> (18, n) canonical limbs; 0 maps to 0.
//
// No Pallas counterpart: in the JAX package this is XLA glue,
// Field.pow_const (halo_accumulation_tpu/ops/field.py:308) at the root of
// Field.inv's product tree (:320), a fori_loop of 255 squarings and
// multiplies.  On the card the port's Field.inv hands every lane to this
// kernel in one launch (every to_affine, and FR.inv of each round's
// challenge in the device-transcript open): the lanes run side by side and
// inv makes no host copy.  The plain twin stays Fermat's a^(p - 2).
//
// Algorithm: Bernstein-Yang "safegcd" divsteps in the half-delta form
// (hddivstep), laid out as libsecp256k1's 32-bit modinv32
// (src/modinv32_impl.h) lays it out.  f, g, d, e are nine signed 30-bit
// limbs (270 bits; limbs 0 to 7 in [0, 2^30), limb 8 signed); start f = p,
// g = a, d = 0, e = 1, zeta = -1 (zeta = -(delta + 1/2)).  A batch runs 30
// divsteps on the low 32-bit words of f and g alone, branch-free, and
// gathers them in a 2 x 2 matrix t = [u v; q r] (2^30 times the product of
// the steps' matrices, |u| + |v| <= 2^30, |q| + |r| <= 2^30); then
// (f, g) <- t (f, g) / 2^30, exactly, and (d, e) <- t (d, e) / 2^30 mod p,
// with d and e kept in (-2p, p).  Invariant: d a == f and e a == g (mod p).
//
// The count: hddivstep needs at most 590 divsteps for inputs below 2^256
// (P. Wuille's bound, computed with Bernstein-Yang's hull method, in
// libsecp256k1's doc/safegcd_implementation.md; Bernstein and Yang's own
// bound for their divstep, "Fast constant-time gcd computation and modular
// inversion", 2019, is floor((49 d + 57) / 17) = 741 at d = 256).  So
// kBatches = 20 batches of kBatch = 30, 600 divsteps, bring g to 0 and f
// to +-gcd(p, a) = +-1 for every a in [1, p), and d to +-a^-1; the result
// is d sign(f), normalized into [0, p).  For a = 0, g is 0 throughout: f
// stays p, d stays 0, and 0 maps to 0.
//
// Facts about both Pasta primes used here, as field.cuh states its own:
// p == 1 (mod 2^32), so p^-1 mod 2^30 is 1, and the multiple m of p that
// clears the low 30 bits of limb 0 of t (d, e) is its negated low bits,
// no product; p's 30-bit limbs are 1, three limbs of c, 0x22, 0, 0, 0 and
// 0x4000 (from q_word below), so limbs 0 and 5 to 8 cost no product.
//
// One lane per thread: load into 8 words (field.cuh, the modulus a
// template parameter), one conditional subtraction of p (the boundary's
// lazy limbs hold values up to 2^257; load_fe leaves a value below 2^255 <
// 2p), then 30-bit limbs; store canonical limbs.  Work a lane: 600 divsteps
// of 27 two-input 32-bit operations as written (21 with sm_90's
// three-input LOP3 and IADD3) and 20 matrix applications of 80 products
// (36 on f, g; 36 + 8 on d, e).  The open's rounds invert one or two lanes
// a launch, so there a launch is one warp's dependent chain: the divsteps'
// instructions issue one at a time.  chip_smoke.py reports the bound, the
// smaller of this count and Fermat's shortest chain (FINV_DIVSTEP_OPS32,
// finv_least_chain), beside the kernel's own count.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int kLimbs = 9;     // signed 30-bit limbs of f, g, d, e
constexpr int kBatch = 30;    // divsteps a batch
constexpr int kBatches = 20;  // 600 >= 590 divsteps
constexpr int32_t M30 = 0x3FFFFFFF;
constexpr int kThreads = 128;

// limb i of p in the 30-bit form, from field.cuh's words of p
template <class M>
__device__ __forceinline__ int32_t p30(int i) {
  const int j = (30 * i) / 32, off = (30 * i) % 32;
  const uint64_t pair = ((uint64_t)(j + 1 < halo::NW ? M::q_word(j + 1) : 0u) << 32) | M::q_word(j);
  return (int32_t)((pair >> off) & M30);
}

// kBatch divsteps on the low words of f (odd) and g; the matrix to t as
// {u, v, q, r}, the new zeta returned.  u, v, q, r are residues mod 2^32 of
// values in [-2^30, 2^30].
__device__ __forceinline__ int32_t divsteps(int32_t zeta, uint32_t f, uint32_t g, int32_t (&t)[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);  // all ones if delta > 0
    const uint32_t c2 = 0u - (g & 1u);           // all ones if g is odd
    const uint32_t c3 = c1 & c2;                 // all ones if the step swaps
    // g += c2 ? (c1 ? -f : f) : 0, written ((f ^ c1) & c2) - c3: a LOP3
    // and an IADD3
    g += ((f ^ c1) & c2) - c3;
    q += ((u ^ c1) & c2) - c3;
    r += ((v ^ c1) & c2) - c3;
    zeta = (zeta ^ (int32_t)c3) - 1;  // a swap: -zeta - 2, else zeta - 1
    f += g & c3;                      // a swap: f + (g - f), the old g
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) <- t (f, g) / 2^30: the low 30 bits of both are 0 by the divsteps
__device__ __forceinline__ void update_fg(int32_t (&f)[kLimbs], int32_t (&g)[kLimbs], const int32_t (&t)[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
  int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) {
    cf += (int64_t)u * f[i] + (int64_t)v * g[i];
    cg += (int64_t)q * f[i] + (int64_t)r * g[i];
    f[i - 1] = (int32_t)cf & M30;
    g[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f[kLimbs - 1] = (int32_t)cf;
  g[kLimbs - 1] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me the multiples of p
// that clear the low 30 bits (p^-1 == 1 mod 2^30) plus p for each negative
// input, so that the outputs stay in (-2p, p)
template <class M>
__device__ __forceinline__ void update_de(int32_t (&d)[kLimbs], int32_t (&e)[kLimbs], const int32_t (&t)[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[kLimbs - 1] >> 31, se = e[kLimbs - 1] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)(((uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)(((uint32_t)ce + (uint32_t)me) & M30);
  cd += md;  // p's limb 0 is 1
  ce += me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)p30<M>(i) * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)p30<M>(i) * me;
    d[i - 1] = (int32_t)cd & M30;
    e[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d[kLimbs - 1] = (int32_t)cd;
  e[kLimbs - 1] = (int32_t)ce;
}

// propagate the limbs' carries upward: limbs 0 to 7 into [0, 2^30)
__device__ __forceinline__ void carry30(int32_t (&d)[kLimbs]) {
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) {
    d[i] += d[i - 1] >> 30;
    d[i - 1] &= M30;
  }
}

// d in (-2p, p) -> d sign(f) in [0, p): add p if d < 0, negate if f < 0
// (now in (-p, p)), add p if still negative
template <class M>
__device__ __forceinline__ void normalize(int32_t (&d)[kLimbs], int32_t fsign) {
  const int32_t add1 = d[kLimbs - 1] >> 31, neg = fsign >> 31;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) d[i] = ((d[i] + (p30<M>(i) & add1)) ^ neg) - neg;
  carry30(d);
  const int32_t add2 = d[kLimbs - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) d[i] += p30<M>(i) & add2;
  carry30(d);
}

template <class M>
__device__ __forceinline__ halo::Fe divstep_inv(const halo::Fe& a) {
  // a mod p: a < 2^255 < 2p, so subtract p unless that borrows
  uint32_t w[halo::NW], s[halo::NW];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) {
    acc += (int64_t)a.v[i] - (int64_t)M::q_word(i);
    s[i] = (uint32_t)acc;
    acc >>= 32;
  }
#pragma unroll
  for (int i = 0; i < halo::NW; ++i) w[i] = acc < 0 ? a.v[i] : s[i];
  int32_t f[kLimbs], g[kLimbs], d[kLimbs], e[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int j = (30 * i) / 32, off = (30 * i) % 32;
    const uint64_t pair = ((uint64_t)(j + 1 < halo::NW ? w[j + 1] : 0u) << 32) | w[j];
    g[i] = (int32_t)((pair >> off) & M30);
    f[i] = p30<M>(i);
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t zeta = -1;
#pragma unroll 1
  for (int b = 0; b < kBatches; ++b) {
    int32_t t[4];
    zeta = divsteps(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de<M>(d, e, t);
    update_fg(f, g, t);
  }
  normalize<M>(d, f[kLimbs - 1]);
  uint32_t c[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) c[i] = (uint32_t)d[i];
  return halo::from_chunks<kLimbs, 30, M>(c);
}

template <class M>
__global__ void __launch_bounds__(kThreads) finv_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ o,
                                                   int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  halo::store_fe<M>(o, n, i, divstep_inv<M>(halo::load_fe<M>(a, n, i)));
}

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
