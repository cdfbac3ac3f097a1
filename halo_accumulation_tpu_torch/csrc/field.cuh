// Fq and Fr arithmetic on 8 x 32-bit words, one field element per thread.
//
// The modulus is a template parameter (Fq, the default, or Fr below); both
// Pasta primes have the same shape, q = 2^254 + c with a 126-bit c:
//   Fq: c = 0x224698fc094cf91b992d30ed00000001,
//   Fr: c = 0x224698fc0994a8dd8c46eb2100000001.
// Below, q names either modulus and c its own constant.  So
// 2^256 = 4q - 4c == -4c (mod q), 4c < 2^127.1 fills four words, and the
// low word of c is 1 (q == 1 mod 2^32): for Fr as for Fq, since the proof
// below uses only these facts (c < 2^126, 4c < 2^127.1 with the same top
// word 0x891a63f0, c's word 0 equal to 1), it holds for both as it stands.  The multiply is pseudo-Mersenne:
// schoolbook 8 x 8 words, then two folds of the high half by -4c, then one
// small fold (finish) that subtracts a multiple of q picked from the top
// bits.  No Montgomery domain, so loads and stores cost no multiply.
//
// Invariant: an Fe holds a value V = sum v[i] 2^(32 i) with 0 <= V < 2^255
// (word 7 < 0x80000000), any representative of its residue mod q.
//
// finish(x, top): X = x + top 2^256, top a signed int, |top| < 2^24.  With
// f = floor(X / 2^254) = 4 top + (x[7] >> 30) and h = f - 1 if f > 0 else
// f, it returns R = X - h q.  Write r = X mod 2^254 in [0, 2^254):
//   f >= 1:  R = r + 2^254 - (f - 1) c, in [2^254 - (f - 1) c, 2^255);
//   f <= 0:  R = r + |f| c,             in [0, 2^254 + |f| c);
// both inside [0, 2^255) since |f| c < 2^254 for |f| < 2^128.  R lies in
// [0, 2^256), so it is computed mod 2^256: R = x + g c + g 2^254 with
// g = -h, the small multiple of c formed with signed carries.
// Each operation ends in finish, which gives the invariant back:
//   add:       X = a + b < 2^256, top 0 or 1.
//   sub:       X = a - b in (-2^255, 2^255), top -1 or 0 (the borrow).
//   mul_small: X = a k < 2^271 for k < 2^16, top < 2^15.
//   mul:       t = a b < 2^512 (inputs below 2^256 suffice), t = L + H 2^256
//              with H < 2^256; D = 4c H < 2^383.1 = D_lo + D_hi 2^256 with
//              D_hi < 2^127.1 (4 words); E = 4c D_hi < 2^254.2.  Then
//              t == L - D == L - D_lo + E = X in (-2^256, 2^256 + 2^254.2),
//              top in {-1, 0, 1}.
// 32-bit products: mul 64 + 24 + 12 + 3 = 103 (the low word of 4c is 4 and
// that of c is 1: shifts, not products); mul_small 8 + 3; add, sub 3.
//
// Boundary: the torch code holds (18, n) int64 planes of 15-bit limbs
// (ops/field.py), nearly clean (<= 2^15 + eps) with values below 2^257.
// load_fe packs the limbs into words once (limbs below 2^24 suffice) and
// finishes; store_fe writes CANONICAL limbs: clean 15-bit limbs of V mod q
// (V < 2^255 < 2q, so one conditional subtraction of q), FQ.canon's form.
// So a kernel's output equals FQ.canon of its plain twin limb for limb.
//
// The Fq instance is the code every kernel ran before the template: the
// names without a modulus (mul, sub, mul_small, add, load_fe, store_fe,
// from_chunks) are Fq's.
//
// Carry chains are written with 64-bit accumulators (IMAD.WIDE.U32 and
// adds), not inline PTX, so no asm carry flag has to survive between
// statements.  Loops have compile-time bounds and are fully unrolled so the
// arrays stay in registers (ptxas reports spills with -Xptxas -v).
#pragma once
#include <stdint.h>

namespace halo {

constexpr int L = 18;   // 15-bit limbs of a boundary plane
constexpr int NW = 8;   // 32-bit words of a field element in registers
constexpr uint32_t M15 = 0x7FFF;

// The moduli: c = q - 2^254 and 4c, four words each (word 0 is 1 and 4),
// and q itself (words 4 to 6 zero, word 7 2^30).
struct Fq {
  static __device__ __forceinline__ uint32_t c_word(int i) {
    constexpr uint32_t d[4] = {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu};
    return d[i];
  }
  static __device__ __forceinline__ uint32_t c4_word(int i) {
    constexpr uint32_t d[4] = {0x00000004u, 0x64b4c3b4u, 0x2533e46eu, 0x891a63f0u};
    return d[i];
  }
  static __device__ __forceinline__ uint32_t q_word(int i) {
    constexpr uint32_t d[NW] = {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
                                0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return d[i];
  }
};
struct Fr {
  static __device__ __forceinline__ uint32_t c_word(int i) {
    constexpr uint32_t d[4] = {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu};
    return d[i];
  }
  static __device__ __forceinline__ uint32_t c4_word(int i) {
    constexpr uint32_t d[4] = {0x00000004u, 0x311bac84u, 0x2652a376u, 0x891a63f0u};
    return d[i];
  }
  static __device__ __forceinline__ uint32_t q_word(int i) {
    constexpr uint32_t d[NW] = {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
                                0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return d[i];
  }
};
// R = x + top 2^256 - h q in [0, 2^255) (see the header).
template <class M = Fq>
__device__ __forceinline__ void finish(const uint32_t (&x)[NW], int top, uint32_t (&r)[NW]) {
  const int f = 4 * top + (int)(x[NW - 1] >> 30);
  const int g = f > 0 ? 1 - f : -f;  // -h
  uint32_t m[NW];                    // g q mod 2^256
  int64_t acc = g;                   // g times c's word 0, which is 1
  m[0] = (uint32_t)acc;
  acc >>= 32;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    acc += (int64_t)g * (int64_t)M::c_word(i);
    m[i] = (uint32_t)acc;
    acc >>= 32;
  }
#pragma unroll
  for (int i = 4; i < NW; ++i) {
    m[i] = (uint32_t)acc;  // the sign extension of g c
    acc >>= 32;
  }
  m[NW - 1] += (uint32_t)g << 30;  // g 2^254
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)x[i] + m[i] + carry;
    r[i] = (uint32_t)s;
    carry = s >> 32;
  }
}

// out = 4c * h: N words times four -> N + 4 words, row by row.
template <int N, class M = Fq>
__device__ __forceinline__ void mul_c4(const uint32_t (&h)[N], uint32_t (&out)[N + 4]) {
#pragma unroll
  for (int j = 0; j < N + 4; ++j) out[j] = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)M::c4_word(k) * h[j] + out[k + j] + carry;  // k = 0: a shift by 2
      out[k + j] = (uint32_t)s;
      carry = s >> 32;
    }
    out[k + N] = (uint32_t)carry;
  }
}

template <class M = Fq>
__device__ __forceinline__ void fe_mul(const uint32_t (&a)[NW], const uint32_t (&b)[NW],
                                       uint32_t (&r)[NW]) {
  // t = a b, 16 words, row by row: each step a[i] b[j] + t + carry < 2^64
  uint32_t t[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)a[i] * b[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    t[i + NW] = (uint32_t)carry;
  }
  // first fold: D = 4c H (12 words); second: E = 4c D_hi (8 words)
  uint32_t hi[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) hi[j] = t[NW + j];
  uint32_t d[NW + 4];
  mul_c4<NW, M>(hi, d);
  const uint32_t dh[4] = {d[NW], d[NW + 1], d[NW + 2], d[NW + 3]};
  uint32_t e[8];
  mul_c4<4, M>(dh, e);
  // X = L - D_lo + E with a signed carry; its last carry is the top word
  uint32_t x[NW];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (int64_t)t[i] - (int64_t)d[i] + (int64_t)e[i];
    x[i] = (uint32_t)acc;
    acc >>= 32;
  }
  finish<M>(x, (int)acc, r);
}

template <class M = Fq>
__device__ __forceinline__ void fe_add(const uint32_t (&a)[NW], const uint32_t (&b)[NW],
                                       uint32_t (&r)[NW]) {
  uint32_t x[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)a[i] + b[i] + carry;
    x[i] = (uint32_t)s;
    carry = s >> 32;
  }
  finish<M>(x, (int)carry, r);
}

template <class M = Fq>
__device__ __forceinline__ void fe_sub(const uint32_t (&a)[NW], const uint32_t (&b)[NW],
                                       uint32_t (&r)[NW]) {
  uint32_t x[NW];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (int64_t)a[i] - (int64_t)b[i];
    x[i] = (uint32_t)acc;
    acc >>= 32;
  }
  finish<M>(x, (int)acc, r);  // -1 after a borrow
}

template <class M = Fq>
__device__ __forceinline__ void fe_mul_small(const uint32_t (&a)[NW], uint32_t k,
                                             uint32_t (&r)[NW]) {
  uint32_t x[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)a[i] * k + carry;
    x[i] = (uint32_t)s;
    carry = s >> 32;
  }
  finish<M>(x, (int)carry, r);
}

// Value form used by the curve formulas.  Arguments travel by value.
// mul, sub and mul_small are called, not inlined, unless a kernel defines
// HALO_INLINE_FIELD_OPS before the include.  The bucket kernels run a whole
// padd a loop step: inlined there, they held up to 255 registers, spilled,
// ran 1.1 to 1.8 times slower and took 47 s to build.  padd.cu and pdbl.cu
// run one or two of each a thread and inline them: their launches took 7
// to 17 % less time (PERF.md).
#ifdef HALO_INLINE_FIELD_OPS
#define HALO_FIELD_OP __device__ __forceinline__
#else
#define HALO_FIELD_OP __device__ __noinline__
#endif

struct Fe {
  uint32_t v[NW];
};

HALO_FIELD_OP Fe mul(Fe a, Fe b) {
  Fe r;
  fe_mul(a.v, b.v, r.v);
  return r;
}

HALO_FIELD_OP Fe sub(Fe a, Fe b) {
  Fe r;
  fe_sub(a.v, b.v, r.v);
  return r;
}

HALO_FIELD_OP Fe mul_small(Fe a, uint32_t k) {
  Fe r;
  fe_mul_small(a.v, k, r.v);
  return r;
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe r;
  fe_add(a.v, b.v, r.v);
  return r;
}

__device__ __forceinline__ Fe fe_word(uint32_t w0) {
  Fe a;
#pragma unroll
  for (int i = 0; i < NW; ++i) a.v[i] = i == 0 ? w0 : 0u;
  return a;
}

// N chunks of BITS bits each -> an Fe: chunk i adds c[i] << off into the
// 64-bit column of word (BITS i) / 32, one carry pass packs the columns,
// and the carry out of word 7 is finish's top.  Nearly clean 15-bit limbs
// (below 2^24) and clean 30-bit pairs keep every column below 2^63 and the
// value below 2^280.
template <int N, int BITS, class M = Fq>
__device__ __forceinline__ Fe from_chunks(const uint32_t (&c)[N]) {
  static_assert((BITS * (N - 1)) / 32 < NW, "every chunk starts inside the eight words");
  uint64_t col[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) col[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) col[(BITS * i) / 32] += (uint64_t)c[i] << ((BITS * i) % 32);
  uint32_t x[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = col[j] + carry;
    x[j] = (uint32_t)s;
    carry = s >> 32;
  }
  Fe r;
  finish<M>(x, (int)carry, r.v);
  return r;
}

// int64 limb planes (torch's boundary dtype) <-> registers.  Plane i of an
// (18, n) tensor starts at i * stride.
template <class M = Fq>
__device__ __forceinline__ Fe load_fe(const int64_t* p, int64_t stride, int64_t col) {
  uint32_t c[L];
#pragma unroll
  for (int i = 0; i < L; ++i) c[i] = (uint32_t)p[i * stride + col];
  return from_chunks<L, 15, M>(c);
}

// The canonical limbs of a: V mod q (V < 2^255 < 2q: subtract q unless that
// borrows), then 15 bits a limb.
template <class M = Fq>
__device__ __forceinline__ void store_fe(int64_t* p, int64_t stride, int64_t col, const Fe& a) {
  uint32_t d[NW];
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (int64_t)a.v[i] - (int64_t)M::q_word(i);
    d[i] = (uint32_t)acc;
    acc >>= 32;
  }
  const bool lt = acc < 0;  // V < q
  uint32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = lt ? a.v[i] : d[i];
  w[NW] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    constexpr int kBits = 15;
    const int j = (kBits * i) / 32, off = (kBits * i) % 32;
    const uint64_t pair = ((uint64_t)w[j + 1] << 32) | w[j];
    p[i * stride + col] = (int64_t)((pair >> off) & M15);
  }
}

}  // namespace halo
