// Fq arithmetic on 18 x 15-bit lazy limbs, one field element per thread.
//
// Device-function twin of the list-form limb math of
// halo_accumulation_tpu/ops/limbs.py (ListField) and, limb for limb, of the
// stacked torch code in halo_accumulation_tpu_torch/ops/field.py: the same
// schoolbook columns with a per-product (lo & 0x7FFF, hi >> 15) split, the
// same two-pass lazy carries, the same 2^255 = -2c fold and the same
// borrow-free K - b subtraction.  Every array below has the length its
// Python twin has, so a kernel built on these functions returns the plain
// torch version's limbs exactly.
//
// Limbs are uint32 in registers.  Nearly clean limbs are <= 0x8008, so a
// limb product is < 2^31 and a column of 36 split halves is < 2^22: nothing
// wraps.  Loops have compile-time bounds and are fully unrolled so the
// arrays stay in registers (ptxas reports spills with -Xptxas -v).
//
// The host hands limbs over as int64 planes, the dtype the torch code holds
// (torch's CPU uint32 lacks +, >> and comparisons); every limb fits in 31
// bits, so the kernels narrow them to uint32 on load and widen on store.
#pragma once
#include <stdint.h>

namespace halo {

constexpr int L = 18;
constexpr uint32_t M15 = 0x7FFF;

// 2c for the Pallas base field q = 2^254 + c, as 9 limbs (ops/field.py
// Field.c2_limbs for FQ).
__device__ __forceinline__ uint32_t c2_digit(int i) {
  constexpr uint32_t d[9] = {2, 0, 1896, 4819, 9075, 21310, 32260, 18072, 68};
  return d[i];
}
// K18: a multiple of q whose 20 digits dominate any 18-limb subtrahend.
__device__ __forceinline__ uint32_t k18_digit(int i) {
  constexpr uint32_t d[20] = {131080, 131076, 138652, 157928, 153876, 154305, 148743,
                              135794, 138098, 131342, 163836, 163835, 163835, 163835,
                              163835, 163835, 163835, 131071, 0,      0};
  return d[i];
}
// K12 = q itself, with digits dominating any 12-limb subtrahend.
__device__ __forceinline__ uint32_t k12_digit(int i) {
  constexpr uint32_t d[18] = {131073, 163836, 148399, 149861, 135605, 141723,
                              147198, 140104, 131102, 163836, 163835, 163835,
                              32763,  32767,  32767,  32767,  16383,  0};
  return d[i];
}

// One carry pass over N limbs, keeping the first NOUT (<= N + 1).
template <int N, int NOUT>
__device__ __forceinline__ void carry_pass(const uint32_t (&x)[N], uint32_t (&out)[NOUT]) {
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    uint32_t v = 0;
    if (i < N) v += x[i] & M15;
    if (i > 0 && i - 1 < N) v += x[i - 1] >> 15;
    out[i] = v;
  }
}

template <int N, int NOUT>
__device__ __forceinline__ void carry_pass2(const uint32_t (&x)[N], uint32_t (&out)[NOUT]) {
  uint32_t t[N + 1];
  carry_pass<N, N + 1>(x, t);
  carry_pass<N + 1, NOUT>(t, out);
}

// Schoolbook columns of 18 x 18 limbs: 37 columns (the last one is zero).
__device__ __forceinline__ void mul_cols(const uint32_t (&a)[L], const uint32_t (&b)[L],
                                         uint32_t (&cols)[2 * L + 1]) {
#pragma unroll
  for (int k = 0; k < 2 * L + 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint32_t p = a[i] * b[j];
      cols[i + j] += p & M15;
      cols[i + j + 1] += p >> 15;
    }
  }
}

// 2c (9 digits) times NB nearly clean limbs: NB + 10 columns.
template <int NB>
__device__ __forceinline__ void mul_c2_cols(const uint32_t (&b)[NB], uint32_t (&cols)[NB + 10]) {
#pragma unroll
  for (int k = 0; k < NB + 10; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (c2_digit(i) == 0) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t p = b[j] * c2_digit(i);
      cols[i + j] += p & M15;
      cols[i + j + 1] += p >> 15;
    }
  }
}

// x: N (18..20) nearly clean limbs, value < 2^273 -> GOOD 18 limbs.
template <int N>
__device__ __forceinline__ void fold_tail(const uint32_t (&x)[N], uint32_t (&out)[L]) {
  constexpr int NH = N - 17;
  uint32_t high[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) high[i] = x[17 + i];
  uint32_t cols[NH + 10];
  mul_c2_cols<NH>(high, cols);
  uint32_t X[12];
  carry_pass2<NH + 10, 12>(cols, X);
  uint32_t s[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t d = k12_digit(i) - (i < 12 ? X[i] : 0u);
    s[i] = (i < 17 ? x[i] : 0u) + d;
  }
  carry_pass<L, L>(s, out);
}

// Full reduction of 39 nearly clean product limbs (value < 2^527).
__device__ __forceinline__ void reduce_wide(const uint32_t (&t)[2 * L + 3], uint32_t (&out)[L]) {
  constexpr int NH0 = 2 * L + 3 - 17;  // 22
  uint32_t h0[NH0];
#pragma unroll
  for (int i = 0; i < NH0; ++i) h0[i] = t[17 + i];
  uint32_t c1[NH0 + 10];
  mul_c2_cols<NH0>(h0, c1);
  uint32_t X1[NH0 + 12];  // 34
  carry_pass2<NH0 + 10, NH0 + 12>(c1, X1);
  constexpr int NH1 = NH0 + 12 - 17;  // 17
  uint32_t h1[NH1];
#pragma unroll
  for (int i = 0; i < NH1; ++i) h1[i] = X1[17 + i];
  uint32_t c2[NH1 + 10];
  mul_c2_cols<NH1>(h1, c2);
  uint32_t X2[20];
  carry_pass2<NH1 + 10, 20>(c2, X2);
  uint32_t h2[3] = {X2[17], X2[18], X2[19]};
  uint32_t c3[13];
  mul_c2_cols<3>(h2, c3);
  uint32_t X3[12];
  carry_pass2<13, 12>(c3, X3);
  // value = (low0 + low2) - (low1 + X3), made borrow-free with K18
  uint32_t s[20];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    uint32_t neg = 0;
    if (i < 17) neg += X1[i];
    if (i < 12) neg += X3[i];
    uint32_t d = k18_digit(i) - neg;
    s[i] = (i < 17 ? t[i] + X2[i] : 0u) + d;
  }
  uint32_t r[20];
  carry_pass<20, 20>(s, r);
  fold_tail<20>(r, out);
}

__device__ __forceinline__ void fe_mul(const uint32_t (&a)[L], const uint32_t (&b)[L],
                                       uint32_t (&out)[L]) {
  uint32_t cols[2 * L + 1];
  mul_cols(a, b, cols);
  uint32_t t[2 * L + 3];
  carry_pass2<2 * L + 1, 2 * L + 3>(cols, t);
  reduce_wide(t, out);
}

__device__ __forceinline__ void fe_add(const uint32_t (&a)[L], const uint32_t (&b)[L],
                                       uint32_t (&out)[L]) {
  uint32_t s[L];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = a[i] + b[i];
  carry_pass<L, L>(s, out);
}

__device__ __forceinline__ void fe_sub(const uint32_t (&a)[L], const uint32_t (&b)[L],
                                       uint32_t (&out)[L]) {
  uint32_t s[20];
#pragma unroll
  for (int i = 0; i < 20; ++i) s[i] = (i < L ? a[i] + (k18_digit(i) - b[i]) : k18_digit(i));
  uint32_t r[20];
  carry_pass<20, 20>(s, r);
  fold_tail<20>(r, out);
}

__device__ __forceinline__ void fe_mul_small(const uint32_t (&a)[L], uint32_t k,
                                             uint32_t (&out)[L]) {
  uint32_t s[L];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = a[i] * k;
  uint32_t r[L + 2];
  carry_pass2<L, L + 2>(s, r);
  fold_tail<L + 2>(r, out);
}

// Value form used by the curve formulas.  mul, sub and mul_small each end in
// a fold and are called, not inlined: inlined, the dozen multiplies of one
// point add make a single straight-line block of tens of thousands of
// instructions, which nvcc takes minutes to compile; called, each kernel
// compiles one body of each.  Arguments travel by value.
struct Fe {
  uint32_t v[L];
};

__device__ __noinline__ Fe mul(Fe a, Fe b) {
  Fe r;
  fe_mul(a.v, b.v, r.v);
  return r;
}

__device__ __noinline__ Fe sub(Fe a, Fe b) {
  Fe r;
  fe_sub(a.v, b.v, r.v);
  return r;
}

__device__ __noinline__ Fe mul_small(Fe a, uint32_t k) {
  Fe r;
  fe_mul_small(a.v, k, r.v);
  return r;
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe r;
  fe_add(a.v, b.v, r.v);
  return r;
}

// int64 limb planes (torch's boundary dtype) <-> registers.  Plane i of an
// (18, n) tensor starts at i * stride.
__device__ __forceinline__ Fe load_fe(const int64_t* p, int64_t stride, int64_t col) {
  Fe x;
#pragma unroll
  for (int i = 0; i < L; ++i) x.v[i] = (uint32_t)p[i * stride + col];
  return x;
}

__device__ __forceinline__ void store_fe(int64_t* p, int64_t stride, int64_t col, const Fe& x) {
#pragma unroll
  for (int i = 0; i < L; ++i) p[i * stride + col] = (int64_t)x.v[i];
}

}  // namespace halo
