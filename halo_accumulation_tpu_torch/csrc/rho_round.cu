// rho_round: one IPA round's Fiat-Shamir challenge on the card,
// xi' = rho_0(ser(xi), ser_point(L), ser_point(R)) reduced into Fr.
//
// No Pallas counterpart: in the JAX package this is XLA glue,
// pcdl._rho_round_device and _ser_point_words
// (halo_accumulation_tpu/pcdl.py:607-640) over ops/keccak.py (SHA3-256 on
// (lo, hi) uint32 pairs, since a TPU has no 64-bit integers).  As torch ops
// one hash would be about 24 x 30 launches, every round; here it is one
// launch of one warp.  Its plain twin is ops/keccak.py's rho_round.
//
// The 102-byte message (utils/serialize.py's layouts):
//   bytes  0..31  xi, 32 bytes little-endian;
//   bytes 32..64  ser_point(L): x (0 at infinity), then the flag byte at 64,
//                 0x40 at infinity, 0x80 when y > (q - 1) / 2, else 0;
//   bytes 65..97  ser_point(R), x from the unaligned byte 65, flag at 97;
//   bytes 98..101 the rho_0 tag, u32 0;
// then SHA3-256's padding (0x06 at byte 102, 0x80 at byte 135) fills one
// 136-byte block.
//
// One warp.  Threads 0 to 4 each pack one 18-limb input into 8 words side
// by side (xi, L.x, L.y, R.x, R.y; the limb vectors are canonical, so each
// word takes its bits straight from at most three limbs; each vector has
// its own stride, so the caller passes column views), and the two y
// threads test y > (q - 1) / 2.  They write the words into a 35-word
// staging row s in shared memory: xi at kXi, L.x at kLx, L's flag as the
// top byte of word kLflag, R.x at kRx, R's flag at kRflag, and the padding
// words from kPad.  Message word j is s[j] for j < 16 and, from the
// unaligned byte 65 on, the funnel shift of s[j] and s[j + 1] by a byte.
// Thread t takes bytes 8 t .. 8 t + 7, words 2 t and 2 t + 1: its 64-bit
// lane of the block, absorbed into the zero state.
//
// keccak-f[1600] (FIPS 202) across the warp: thread t < 25 holds lane t =
// x + 5 y as two 32-bit words; threads 25 to 31 run the same steps on
// copies of lanes 0 to 6 that no thread reads and that they never store.
// A round: theta stores each lane into a column-major copy of the state in
// shared memory (one per round parity, so no barrier guards its reuse);
// each thread reads columns x - 1 and x + 1 (two 16-byte loads and one
// 8-byte load a column) for C[x - 1] ^ rot(C[x + 1], 1), the 1-bit
// rotation two funnel shifts.  rho rotates the thread's own lane, two
// funnel shifts (the words swapped first for rotations of 32 or more: a
// funnel shift takes its count mod 32).  pi and chi together: the lanes
// that pi puts at (x, y), (x + 1, y) and (x + 2, y) come by shuffles, then
// one a ^ (~b & c) (a LOP3) a word, with iota's constant, masked to thread
// 0, folded in.  The 24 rounds are unrolled.  The per-thread tables are
// packed literals decoded by shifts (no memory): kXm, kXp, kX2 the columns
// x - 1, x + 1, x + 2 (a nibble each), and for row y a word of rho's
// rotations (6 bits each) and one of pi's source lanes (5 bits each).
// Shared memory serves theta, whose ten lanes a thread would need twelve
// shuffles in two hops; shuffles serve pi and chi, three lanes a thread:
// on the H100 the other choice was slower for each.
//
// Thread 0 gathers the digest's lanes 1 to 3 and reduces the 256-bit
// digest mod r: q = its top two bits, d - q r, and r added back if that
// went negative (r = 2^254 + c with c < 2^126); then it stores canonical
// Fr limbs.
//
// Bound on the H100: one keccak-f[1600], 24 rounds of 32-bit logic on a
// 200-byte state; at one warp the launch and the rounds' dependent
// exchanges are what it costs; chip_smoke.py reports the rate bound beside
// it (KECCAK_OPS32) and this source's count (KECCAK_IMPL_OPS32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 18;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kLanes = 25;
// the staging row s: where each input's words go, and its length
constexpr int kXi = 0, kLx = 8, kLflag = 16, kRx = 17, kRflag = 25, kPad = 26, kWords = 35;
// columns x - 1, x + 1 and x + 2 of column x, a nibble each
constexpr uint32_t kXm = 0x32104u, kXp = 0x04321u, kX2 = 0x10432u;

__device__ __forceinline__ int nib(uint32_t table, int x) { return (table >> (4 * x)) & 0xF; }

// entry y of five 32-bit literals
__device__ __forceinline__ uint32_t pick(int y, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3, uint32_t r4) {
  return y == 0 ? r0 : y == 1 ? r1 : y == 2 ? r2 : y == 3 ? r3 : r4;
}

// 18 canonical 15-bit limbs (stride apart) -> 8 little-endian 32-bit
// words, each from the limbs that hold its bits
__device__ __forceinline__ void pack(const int64_t* p, int64_t stride, uint32_t (&w)[8]) {
  uint32_t l[L];
#pragma unroll
  for (int i = 0; i < L; ++i) l[i] = (uint32_t)p[i * stride];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int i = (32 * j) / 15; i <= (32 * j + 31) / 15 && i < L; ++i) {
      const int sh = 15 * i - 32 * j;
      v |= sh >= 0 ? l[i] << sh : l[i] >> -sh;
    }
    w[j] = v;
  }
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

// message word j from the staging row: aligned up to byte 63, then shifted
// by the byte of L's flag
__device__ __forceinline__ uint32_t msg_word(const uint32_t* s, int j) {
  return j < 16 ? s[j] : __funnelshift_l(s[j], s[j + 1], 8);
}

__global__ void __launch_bounds__(32) rho_round_kernel(const int64_t* xi, int64_t xs, const int64_t* lx,
                                                       const int64_t* ly, int64_t ls, const uint8_t* linf,
                                                       const int64_t* rx, const int64_t* ry, int64_t rs,
                                                       const uint8_t* rinf, int64_t* out) {
  __shared__ uint32_t s[kWords];
  __shared__ __align__(16) uint2 col[2][5][6];  // the state column-major, col[parity][x][y]
  const int t = threadIdx.x;
  if (t < 5) {  // xi, L.x, L.y, R.x, R.y
    const int64_t* p = t == 0 ? xi : t == 1 ? lx : t == 2 ? ly : t == 3 ? rx : ry;
    const int64_t stride = t == 0 ? xs : t < 3 ? ls : rs;
    const bool inf = t != 0 && (t < 3 ? *linf : *rinf) != 0;
    uint32_t w[8];
    pack(p, stride, w);
    if (t == 2 || t == 4) {
      const uint32_t flag = inf ? 0x40u : (y_is_larger(w) ? 0x80u : 0u);
      if (t == 2) {
        s[kLflag] = flag << 24;
      } else {
        s[kRflag] = flag;
      }
    } else {
      const int at = t == 0 ? kXi : t == 1 ? kLx : kRx;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[at + j] = inf ? 0u : w[j];
    }
  } else if (t < 5 + kWords - kPad) {  // the padding: 0x06 at byte 102, 0x80 at byte 135
    s[kPad + t - 5] = t == 5 ? 0x00000600u : t == 4 + kWords - kPad ? 0x00800000u : 0u;
  }
  __syncwarp();
  uint32_t lo = 0, hi = 0;
  if (t < 17) {
    lo = msg_word(s, 2 * t);
    hi = msg_word(s, 2 * t + 1);
  }

  // the thread's lane, columns, rotation and pi's sources, fixed for all rounds
  const int tt = t < kLanes ? t : t - kLanes;
  const int x = tt % 5, y = tt / 5;
  const int xm = nib(kXm, x), xp = nib(kXp, x), x2 = nib(kX2, x);
  const uint32_t rho_row = pick(y, 0x1b73e040u, 0x14dc6b24u, 0x2766b283u, 0x0854fb69u, 0x0ee3d092u);
  const uint32_t pi_row = pick(y, 0x018930c0u, 0x01682923u, 0x0149b4e1u, 0x0178aca4u, 0x0157b902u);
  const int rot = (rho_row >> (6 * x)) & 63;
  const bool swap = rot >= 32;
  const int pa = (pi_row >> (5 * x)) & 31, pb = (pi_row >> (5 * xp)) & 31, pc = (pi_row >> (5 * x2)) & 31;
  const uint32_t on0 = t == 0 ? 0xFFFFFFFFu : 0u;  // iota's lane
  constexpr uint64_t rc[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
      0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
      0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
      0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
      0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
  };
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    // theta
    uint2(*c)[6] = col[r & 1];
    if (t < kLanes) c[x][y] = make_uint2(lo, hi);
    __syncwarp();
    const uint4 m01 = *reinterpret_cast<const uint4*>(&c[xm][0]), m23 = *reinterpret_cast<const uint4*>(&c[xm][2]);
    const uint4 p01 = *reinterpret_cast<const uint4*>(&c[xp][0]), p23 = *reinterpret_cast<const uint4*>(&c[xp][2]);
    const uint2 m4 = c[xm][4], p4 = c[xp][4];
    const uint32_t mlo = (m01.x ^ m01.z) ^ (m23.x ^ m23.z) ^ m4.x;
    const uint32_t mhi = (m01.y ^ m01.w) ^ (m23.y ^ m23.w) ^ m4.y;
    const uint32_t plo = (p01.x ^ p01.z) ^ (p23.x ^ p23.z) ^ p4.x;
    const uint32_t phi = (p01.y ^ p01.w) ^ (p23.y ^ p23.w) ^ p4.y;
    lo ^= mlo ^ __funnelshift_l(phi, plo, 1);  // C[x - 1] ^ rot(C[x + 1], 1)
    hi ^= mhi ^ __funnelshift_l(plo, phi, 1);
    // rho
    const uint32_t a = swap ? hi : lo, b = swap ? lo : hi;
    const uint32_t rhi = __funnelshift_l(a, b, rot), rlo = __funnelshift_l(b, a, rot);
    // pi and chi, with iota
    const uint32_t ilo = (uint32_t)rc[r] & on0, ihi = (uint32_t)(rc[r] >> 32) & on0;
    const uint32_t alo = __shfl_sync(kAll, rlo, pa), ahi = __shfl_sync(kAll, rhi, pa);
    const uint32_t blo = __shfl_sync(kAll, rlo, pb), bhi = __shfl_sync(kAll, rhi, pb);
    const uint32_t dlo = __shfl_sync(kAll, rlo, pc), dhi = __shfl_sync(kAll, rhi, pc);
    lo = (alo ^ ilo) ^ (~blo & dlo);
    hi = (ahi ^ ihi) ^ (~bhi & dhi);
  }

  // the digest, lanes 0 to 3, as a 256-bit little-endian value, mod r
  uint64_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = ((uint64_t)__shfl_sync(kAll, hi, k) << 32) | __shfl_sync(kAll, lo, k);
  if (t != 0) return;
  constexpr uint64_t rm[4] = {0x8c46eb2100000001ull, 0x224698fc0994a8ddull, 0x0ull, 0x4000000000000000ull};
  // v - q r for q = v >> 254 (q r < 2^256): v mod 2^254 - q c > -r
  const uint64_t q = v[3] >> 62;
  uint64_t carry = 0, borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned __int128 qr = (unsigned __int128)q * rm[j] + carry;
    carry = (uint64_t)(qr >> 64);
    const uint64_t sub = (uint64_t)qr, d = v[j] - sub;
    const uint64_t b1 = v[j] < sub;
    v[j] = d - borrow;
    borrow = b1 | (d < borrow);
  }
  // negative: add r back
  const uint64_t neg = 0 - borrow;
  carry = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t add = rm[j] & neg, s1 = v[j] + add;
    const uint64_t c1 = s1 < add;
    v[j] = s1 + carry;
    carry = c1 | (v[j] < carry);
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
  rho_round_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)xi, xs, (const int64_t*)lx, (const int64_t*)ly, ls, (const uint8_t*)linf,
      (const int64_t*)rx, (const int64_t*)ry, rs, (const uint8_t*)rinf, (int64_t*)out);
  return (int)cudaGetLastError();
}
