// rho_round: one IPA round's Fiat-Shamir challenge on the card,
// xi' = rho_0(ser(xi), ser_point(L), ser_point(R)) reduced into Fr.
//
// No Pallas counterpart: in the JAX package this is XLA glue,
// pcdl._rho_round_device and _ser_point_words
// (halo_accumulation_tpu/pcdl.py:607-640) over ops/keccak.py (SHA3-256 on
// (lo, hi) uint32 pairs, since a TPU has no 64-bit integers).  As torch ops
// one hash would be about 24 x 30 launches, every round; here it is one
// launch of one thread.  Its plain twin is ops/keccak.py's rho_round.
//
// The thread assembles the 102-byte message (utils/serialize.py's layouts):
//   bytes  0..31  xi, 32 bytes little-endian;
//   bytes 32..64  ser_point(L): x (0 at infinity), then the flag byte at 64,
//                 0x40 at infinity, 0x80 when y > (q - 1) / 2, else 0;
//   bytes 65..97  ser_point(R), x from the unaligned byte 65, flag at 97;
//   bytes 98..101 the rho_0 tag, u32 0;
// absorbs it in one block of SHA3-256 (rate 136, padding 0x06 .. 0x80) on
// native 64-bit lanes, reads the 32-byte digest little-endian and reduces
// it mod r (the digest is below 2^256 < 4r: at most three subtractions),
// and stores canonical Fr limbs.  The limb inputs are canonical (to_affine
// and rho_round's own output), each a vector of 18 limbs with its own
// stride, so the caller passes column views without copies.
//
// Bound on the H100: one keccak-f[1600], 24 rounds of 64-bit logic on a
// 200-byte state, a serial chain on one thread: the launch and the chain's
// latency are what it costs; chip_smoke.py reports the rate bound beside
// it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 18;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// rotation offset of lane (x, y)
__device__ __forceinline__ int rot(int x, int y) {
  constexpr int r[5][5] = {{0, 36, 3, 41, 18},
                           {1, 44, 10, 45, 2},
                           {62, 6, 43, 15, 61},
                           {28, 55, 25, 21, 56},
                           {27, 20, 39, 8, 14}};
  return r[x][y];
}

__device__ __forceinline__ uint64_t rotl(uint64_t v, int s) {
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

// keccak-f[1600] on lanes a[x + 5 y] (FIPS 202)
__device__ void keccak_f(uint64_t (&a)[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y) b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], rot(x, y));
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kRC[r];
  }
}

// 18 canonical 15-bit limbs (stride apart) -> 8 little-endian 32-bit words
__device__ __forceinline__ void pack(const int64_t* p, int64_t stride, uint32_t (&w)[8]) {
  uint64_t col[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < L; ++i) col[(15 * i) / 32] += (uint64_t)p[i * stride] << ((15 * i) % 32);
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t s = col[j] + carry;
    w[j] = (uint32_t)s;
    carry = s >> 32;
  }
}

__device__ __forceinline__ void put_words(uint8_t* msg, int off, const uint32_t (&w)[8]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) msg[off + j] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
}

// y > (q - 1) / 2 for canonical y, from the top word down
__device__ __forceinline__ bool y_is_larger(const uint32_t (&y)[8]) {
  constexpr uint32_t h[8] = {0x80000000u, 0xcc969876u, 0x04a67c8du, 0x11234c7eu,
                             0x00000000u, 0x00000000u, 0x00000000u, 0x20000000u};
#pragma unroll
  for (int j = 7; j >= 0; --j)
    if (y[j] != h[j]) return y[j] > h[j];
  return false;
}

// ser_point(P) at msg[off .. off + 32]
__device__ __forceinline__ void put_point(uint8_t* msg, int off, const int64_t* px, const int64_t* py,
                                          int64_t stride, const uint8_t* inf) {
  uint32_t x[8], y[8];
  pack(px, stride, x);
  pack(py, stride, y);
  const bool at_inf = *inf != 0;
  if (at_inf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = 0;
  }
  put_words(msg, off, x);
  msg[off + 32] = at_inf ? 0x40 : (y_is_larger(y) ? 0x80 : 0);
}

__global__ void rho_round_kernel(const int64_t* xi, int64_t xs, const int64_t* lx, const int64_t* ly,
                                 int64_t ls, const uint8_t* linf, const int64_t* rx, const int64_t* ry,
                                 int64_t rs, const uint8_t* rinf, int64_t* out) {
  uint8_t msg[136];
#pragma unroll
  for (int i = 0; i < 136; ++i) msg[i] = 0;
  uint32_t w[8];
  pack(xi, xs, w);
  put_words(msg, 0, w);
  put_point(msg, 32, lx, ly, ls, linf);
  put_point(msg, 65, rx, ry, rs, rinf);
  // bytes 98..101: the tag 0; then SHA3's padding of a 102-byte message
  msg[102] ^= 0x06;
  msg[135] ^= 0x80;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= (uint64_t)msg[8 * i + k] << (8 * k);
    a[i] = v;
  }
  keccak_f(a);
  // the digest a[0..3] as a 256-bit little-endian value, mod r
  constexpr uint64_t r[4] = {0x8c46eb2100000001ull, 0x224698fc0994a8ddull, 0x0ull, 0x4000000000000000ull};
  uint64_t v[4] = {a[0], a[1], a[2], a[3]};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint64_t d[4], borrow = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t s = v[j] - r[j];
      const uint64_t b1 = v[j] < r[j];
      d[j] = s - borrow;
      borrow = b1 | (s < borrow);
    }
    if (!borrow) {  // v >= r
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = d[j];
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int bit = 15 * i, j = bit / 64, off = bit % 64;
    uint64_t limb = v[j] >> off;
    if (off > 49 && j < 3) limb |= v[j + 1] << (64 - off);
    out[i] = (int64_t)(limb & 0x7FFF);
  }
}

}  // namespace

// limb vectors xi, L.x, L.y, R.x, R.y with element strides xs, ls (L's
// coordinates), rs (R's); linf, rinf one byte each (torch.bool); out 18
// contiguous int64 limbs
extern "C" int halo_rho_round(const void* xi, int64_t xs, const void* lx, const void* ly, int64_t ls,
                              const void* linf, const void* rx, const void* ry, int64_t rs,
                              const void* rinf, void* out, void* stream) {
  rho_round_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int64_t*)xi, xs, (const int64_t*)lx, (const int64_t*)ly, ls, (const uint8_t*)linf,
      (const int64_t*)rx, (const int64_t*)ry, rs, (const uint8_t*)rinf, (int64_t*)out);
  return (int)cudaGetLastError();
}
