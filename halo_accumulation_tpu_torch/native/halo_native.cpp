// Native CPU backend of halo_accumulation_tpu_torch, the PyTorch port.
//
// A copy of halo_accumulation_tpu/native/halo_native.cpp, the JAX
// package's native backend, kept in the port so that the port imports and
// builds nothing of the JAX package.  It plays the role arkworks plays for
// the Rust reference: a fast host-side implementation of the Pasta fields,
// the Pallas curve (Jacobian coordinates), Pippenger MSM, SHA3-256 and URS
// generation.  The port's hostops.py runs the protocol's single-point
// transcript steps on it; fields.py stays the oracle it is held to.
//
// Field elements cross the C ABI as 32-byte little-endian canonical ints;
// affine points as x||y (64 bytes), with (0,0) encoding the identity
// (safe: y^2 = x^3 + 5 has no point with x=y=0).
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O3 -march=native -shared -fPIC -o <lib>.so halo_native.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <thread>

using u64 = uint64_t;
using u128 = unsigned __int128;

struct F4 { u64 v[4]; };

struct FieldCtx {
    u64 mod[4];
    u64 inv;    // -mod^{-1} mod 2^64
    F4 r2;      // (2^256)^2 mod p, Montgomery form of 2^256
    F4 one;     // Montgomery form of 1
};

static bool geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

static void sub_nocheck(u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)a[i] - b[i] - borrow;
        a[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
}

static void add_mod(const F4& a, const F4& b, F4& out, const FieldCtx& F) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)a.v[i] + b.v[i] + carry;
        out.v[i] = (u64)cur;
        carry = cur >> 64;
    }
    if (carry || geq(out.v, F.mod)) sub_nocheck(out.v, F.mod);
}

static void sub_mod(const F4& a, const F4& b, F4& out, const FieldCtx& F) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)a.v[i] - b.v[i] - borrow;
        out.v[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 cur = (u128)out.v[i] + F.mod[i] + carry;
            out.v[i] = (u64)cur;
            carry = cur >> 64;
        }
    }
}

static void neg_mod(const F4& a, F4& out, const FieldCtx& F) {
    bool zero = !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
    if (zero) { out = a; return; }
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)F.mod[i] - a.v[i] - borrow;
        out.v[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
}

// CIOS Montgomery multiplication.
static void mont_mul(const F4& a, const F4& b, F4& out, const FieldCtx& F) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);

        u64 m = t[0] * F.inv;
        carry = ((u128)t[0] + (u128)m * F.mod[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 cur2 = (u128)t[j] + (u128)m * F.mod[j] + carry;
            t[j - 1] = (u64)cur2;
            carry = cur2 >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
    }
    for (int i = 0; i < 4; ++i) out.v[i] = t[i];
    if (t[4] || geq(out.v, F.mod)) sub_nocheck(out.v, F.mod);
}

static void mont_sqr(const F4& a, F4& out, const FieldCtx& F) { mont_mul(a, a, out, F); }

static bool is_zero(const F4& a) { return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]); }

static void mont_pow(const F4& a, const u64 e[4], F4& out, const FieldCtx& F) {
    F4 acc = F.one;
    for (int i = 3; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            mont_sqr(acc, acc, F);
            if ((e[i] >> b) & 1) mont_mul(acc, a, acc, F);
        }
    }
    out = acc;
}

static void mont_inv(const F4& a, F4& out, const FieldCtx& F) {
    u64 e[4];
    memcpy(e, F.mod, 32);
    // e = p - 2
    u128 borrow = 2;
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)e[i] - borrow;
        e[i] = (u64)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    mont_pow(a, e, out, F);
}

static void to_mont(const F4& a, F4& out, const FieldCtx& F) { mont_mul(a, F.r2, out, F); }

static void from_mont(const F4& a, F4& out, const FieldCtx& F) {
    F4 one_raw = {{1, 0, 0, 0}};
    mont_mul(a, one_raw, out, F);
}

static void field_init(FieldCtx& F, const u64 mod[4]) {
    memcpy(F.mod, mod, 32);
    // inv = -mod^{-1} mod 2^64 via Newton iteration x <- x(2 - m x)
    u64 inv = 1;
    for (int i = 0; i < 6; ++i) inv = inv * (2 - mod[0] * inv);
    F.inv = ~inv + 1;  // negate mod 2^64
    // r2 = 2^512 mod p: start with 2^256 - k*p reduced, then square via
    // repeated doubling of 1 (simplest: compute 2^256 mod p by doubling)
    F4 cur = {{1, 0, 0, 0}};
    for (int i = 0; i < 256; ++i) add_mod(cur, cur, cur, F);  // 2^256 mod p (raw)
    // r2 = (2^256)^2 mod p: mont_mul(x_mont?, ...) not available yet; do
    // doubling again: r2_raw = 2^512 mod p
    F4 cur2 = cur;
    for (int i = 0; i < 256; ++i) add_mod(cur2, cur2, cur2, F);  // 2^512 mod p
    F.r2 = cur2;
    F.one = cur;  // Montgomery form of 1 is 2^256 mod p
}

// --- Pasta primes ---
static const u64 Q_MOD[4] = {0x992d30ed00000001ULL, 0x224698fc094cf91bULL, 0x0000000000000000ULL, 0x4000000000000000ULL};
static const u64 R_MOD[4] = {0x8c46eb2100000001ULL, 0x224698fc0994a8ddULL, 0x0000000000000000ULL, 0x4000000000000000ULL};

static FieldCtx FQ, FR_;
static bool g_init = false;

// --- Curve: Jacobian coordinates over FQ, y^2 = x^3 + 5 ---
struct PtJ { F4 x, y, z; };  // z == 0 -> identity (x,y arbitrary)

static PtJ PT_ID;

static bool pt_is_id(const PtJ& p) { return is_zero(p.z); }

static void pt_dbl(const PtJ& p, PtJ& out) {
    if (pt_is_id(p)) { out = p; return; }
    F4 A, B, C, D, E, Fv, t, t2;
    mont_sqr(p.x, A, FQ);
    mont_sqr(p.y, B, FQ);
    mont_sqr(B, C, FQ);
    add_mod(p.x, B, t, FQ);
    mont_sqr(t, t, FQ);
    sub_mod(t, A, t, FQ);
    sub_mod(t, C, t, FQ);
    add_mod(t, t, D, FQ);             // D = 2((X+B)^2 - A - C)
    add_mod(A, A, E, FQ);
    add_mod(E, A, E, FQ);             // E = 3A
    mont_sqr(E, Fv, FQ);              // F = E^2
    sub_mod(Fv, D, t, FQ);
    sub_mod(t, D, out.x, FQ);         // X3 = F - 2D
    sub_mod(D, out.x, t, FQ);
    mont_mul(E, t, t, FQ);
    add_mod(C, C, t2, FQ);
    add_mod(t2, t2, t2, FQ);
    add_mod(t2, t2, t2, FQ);          // 8C
    mont_mul(p.y, p.z, out.z, FQ);
    add_mod(out.z, out.z, out.z, FQ); // Z3 = 2YZ
    sub_mod(t, t2, out.y, FQ);        // Y3 = E(D - X3) - 8C
}

static void pt_add(const PtJ& p, const PtJ& q, PtJ& out) {
    if (pt_is_id(p)) { out = q; return; }
    if (pt_is_id(q)) { out = p; return; }
    F4 Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, r, V, t, t2;
    mont_sqr(p.z, Z1Z1, FQ);
    mont_sqr(q.z, Z2Z2, FQ);
    mont_mul(p.x, Z2Z2, U1, FQ);
    mont_mul(q.x, Z1Z1, U2, FQ);
    mont_mul(p.y, q.z, S1, FQ);
    mont_mul(S1, Z2Z2, S1, FQ);
    mont_mul(q.y, p.z, S2, FQ);
    mont_mul(S2, Z1Z1, S2, FQ);
    sub_mod(U2, U1, H, FQ);
    sub_mod(S2, S1, r, FQ);
    if (is_zero(H)) {
        if (is_zero(r)) { pt_dbl(p, out); return; }
        out = PT_ID; return;
    }
    add_mod(r, r, r, FQ);             // r = 2(S2 - S1)
    add_mod(H, H, t, FQ);
    mont_sqr(t, I, FQ);               // I = (2H)^2
    mont_mul(H, I, J, FQ);            // J = H I
    mont_mul(U1, I, V, FQ);           // V = U1 I
    mont_sqr(r, t, FQ);
    sub_mod(t, J, t, FQ);
    sub_mod(t, V, t, FQ);
    sub_mod(t, V, out.x, FQ);         // X3 = r^2 - J - 2V
    sub_mod(V, out.x, t, FQ);
    mont_mul(r, t, t, FQ);
    mont_mul(S1, J, t2, FQ);
    add_mod(t2, t2, t2, FQ);
    sub_mod(t, t2, t, FQ);            // Y3 = r(V - X3) - 2 S1 J
    add_mod(p.z, q.z, t2, FQ);
    mont_sqr(t2, t2, FQ);
    sub_mod(t2, Z1Z1, t2, FQ);
    sub_mod(t2, Z2Z2, t2, FQ);
    mont_mul(t2, H, out.z, FQ);       // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    out.y = t;
}

static void pt_neg(PtJ& p) { neg_mod(p.y, p.y, FQ); }

// scalar as 4x u64 little-endian (canonical, < r)
static void pt_mul(const PtJ& p, const u64 k[4], PtJ& out) {
    PtJ acc = PT_ID;
    bool started = false;
    for (int i = 3; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            if (started) pt_dbl(acc, acc);
            if ((k[i] >> b) & 1) {
                if (started) pt_add(acc, p, acc);
                else { acc = p; started = true; }
            }
        }
    }
    out = acc;
}

// --- Conversions across the ABI ---
static void bytes_to_f4(const uint8_t* b, F4& out) {
    for (int i = 0; i < 4; ++i) {
        u64 v = 0;
        for (int j = 7; j >= 0; --j) v = (v << 8) | b[i * 8 + j];
        out.v[i] = v;
    }
}

static void f4_to_bytes(const F4& a, uint8_t* b) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) b[i * 8 + j] = (uint8_t)(a.v[i] >> (8 * j));
}

static void load_affine(const uint8_t* b, PtJ& out) {
    F4 x, y;
    bytes_to_f4(b, x);
    bytes_to_f4(b + 32, y);
    if (is_zero(x) && is_zero(y)) { out = PT_ID; return; }
    to_mont(x, out.x, FQ);
    to_mont(y, out.y, FQ);
    out.z = FQ.one;
}

static void store_affine(const PtJ& p, uint8_t* b) {
    if (pt_is_id(p)) { memset(b, 0, 64); return; }
    F4 zi, zi2, zi3, x, y;
    mont_inv(p.z, zi, FQ);
    mont_sqr(zi, zi2, FQ);
    mont_mul(zi2, zi, zi3, FQ);
    mont_mul(p.x, zi2, x, FQ);
    mont_mul(p.y, zi3, y, FQ);
    from_mont(x, x, FQ);
    from_mont(y, y, FQ);
    f4_to_bytes(x, b);
    f4_to_bytes(y, b + 32);
}

// --- Keccak / SHA3-256 (compact) ---
static const u64 KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL, 0x8000000080008000ULL,
    0x000000000000808bULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
    0x000000000000008aULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
    0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800aULL, 0x800000008000000aULL,
    0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline u64 rotl(u64 x, int s) { return (x << s) | (x >> (64 - s)); }

static void keccak_f(u64 st[25]) {
    for (int round = 0; round < 24; ++round) {
        u64 bc[5], t;
        for (int i = 0; i < 5; ++i)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; ++i) {
            t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
        }
        // rho + pi (classic 24-step lane chase)
        static const int rotc[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
        static const int piln[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
        t = st[1];
        for (int i = 0; i < 24; ++i) {
            int j = piln[i];
            u64 tmp = st[j];
            st[j] = rotl(t, rotc[i]);
            t = tmp;
        }
        // chi
        for (int j = 0; j < 25; j += 5) {
            u64 row[5];
            for (int i = 0; i < 5; ++i) row[i] = st[j + i];
            for (int i = 0; i < 5; ++i) st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
        }
        st[0] ^= KRC[round];
    }
}

static void sha3_256(const uint8_t* data, size_t len, uint8_t out[32]) {
    u64 st[25] = {0};
    const size_t rate = 136;
    uint8_t block[136];
    while (len >= rate) {
        for (size_t i = 0; i < rate / 8; ++i) {
            u64 v = 0;
            for (int j = 7; j >= 0; --j) v = (v << 8) | data[i * 8 + j];
            st[i] ^= v;
        }
        keccak_f(st);
        data += rate;
        len -= rate;
    }
    memset(block, 0, rate);
    memcpy(block, data, len);
    block[len] = 0x06;
    block[rate - 1] |= 0x80;
    for (size_t i = 0; i < rate / 8; ++i) {
        u64 v = 0;
        for (int j = 7; j >= 0; --j) v = (v << 8) | block[i * 8 + j];
        st[i] ^= v;
    }
    keccak_f(st);
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) out[i * 8 + j] = (uint8_t)(st[i] >> (8 * j));
}

// reduce 32 bytes LE mod r (from_le_bytes_mod_order)
static void reduce_mod_r(const uint8_t b[32], u64 out[4]) {
    // value < 2^256 < 4r: subtract r up to 3 times
    F4 v;
    bytes_to_f4(b, v);
    while (geq(v.v, FR_.mod)) sub_nocheck(v.v, FR_.mod);
    memcpy(out, v.v, 32);
}

static void ensure_init() {
    if (g_init) return;
    field_init(FQ, Q_MOD);
    field_init(FR_, R_MOD);
    memset(&PT_ID, 0, sizeof(PT_ID));
    PT_ID.x = FQ.one;  // arbitrary; z=0 marks identity
    PT_ID.y = FQ.one;
    memset(PT_ID.z.v, 0, 32);
    g_init = true;
}

// --- Pippenger MSM ---
static void msm_range(const uint8_t* scalars, const uint8_t* points, size_t lo, size_t hi, PtJ& out) {
    size_t n = hi - lo;
    int c = 3;
    if (n > 32) c = 7;
    if (n > 1024) c = 11;
    if (n > 65536) c = 14;
    int windows = (255 + c - 1) / c;
    std::vector<PtJ> pts(n);
    for (size_t i = 0; i < n; ++i) load_affine(points + 64 * (lo + i), pts[i]);
    std::vector<u64> sc(n * 4);
    for (size_t i = 0; i < n; ++i) {
        F4 s;
        bytes_to_f4(scalars + 32 * (lo + i), s);
        memcpy(&sc[i * 4], s.v, 32);
    }
    PtJ acc = PT_ID;
    std::vector<PtJ> buckets((size_t)1 << c);
    for (int w = windows - 1; w >= 0; --w) {
        for (int k = 0; k < c; ++k) pt_dbl(acc, acc);
        size_t nb = (size_t)1 << c;
        for (size_t b = 0; b < nb; ++b) buckets[b] = PT_ID;
        int bit0 = w * c;
        for (size_t i = 0; i < n; ++i) {
            int limb = bit0 >> 6, off = bit0 & 63;
            u64 d = sc[i * 4 + limb] >> off;
            if (off + c > 64 && limb < 3) d |= sc[i * 4 + limb + 1] << (64 - off);
            d &= (((u64)1 << c) - 1);
            if (d) pt_add(buckets[d], pts[i], buckets[d]);
        }
        PtJ run = PT_ID, sum = PT_ID;
        for (size_t b = nb - 1; b >= 1; --b) {
            pt_add(run, buckets[b], run);
            pt_add(sum, run, sum);
        }
        pt_add(acc, sum, acc);
    }
    out = acc;
}

extern "C" {

// MSM: n points (64B affine each), n scalars (32B LE canonical); out 64B affine.
void halo_msm(uint64_t n, const uint8_t* scalars, const uint8_t* points, uint8_t* out) {
    ensure_init();
    unsigned nt = std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 4) nt = 4;
    if (n < 1024) nt = 1;
    std::vector<PtJ> partial(nt);
    std::vector<std::thread> ths;
    size_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        size_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) { partial[t] = PT_ID; continue; }
        ths.emplace_back([&, t, lo, hi]() { msm_range(scalars, points, lo, hi, partial[t]); });
    }
    for (auto& th : ths) th.join();
    PtJ acc = PT_ID;
    for (unsigned t = 0; t < nt; ++t) pt_add(acc, partial[t], acc);
    store_affine(acc, out);
}

// scalar mul: point 64B, scalar 32B -> out 64B
void halo_scalar_mul(const uint8_t* point, const uint8_t* scalar, uint8_t* out) {
    ensure_init();
    PtJ p;
    load_affine(point, p);
    F4 s;
    bytes_to_f4(scalar, s);
    PtJ r;
    pt_mul(p, s.v, r);
    store_affine(r, out);
}

void halo_point_add(const uint8_t* a, const uint8_t* b, uint8_t* out) {
    ensure_init();
    PtJ p, q, r;
    load_affine(a, p);
    load_affine(b, q);
    pt_add(p, q, r);
    store_affine(r, out);
}

void halo_sha3_256(const uint8_t* data, uint64_t len, uint8_t* out) {
    sha3_256(data, len, out);
}

// URS generation (main.rs:18-45 semantics): writes n affine points (64B
// each) for generator indices [start, start+n).
void halo_urs(uint64_t start, uint64_t n, uint8_t* out) {
    ensure_init();
    static const char* genesis = "To understand recursion, one must first understand recursion";
    size_t glen = strlen(genesis);
    // fixed-base window tables for G = (-1, 2): T[w][j] = j * 2^(8w) G
    static std::vector<PtJ> table;  // 32 * 256
    static bool table_init = false;
    if (!table_init) {
        table.assign(32 * 256, PT_ID);
        F4 gx_raw = {{0, 0, 0, 0}}, gy_raw = {{2, 0, 0, 0}};
        // gx = q - 1
        memcpy(gx_raw.v, Q_MOD, 32);
        gx_raw.v[0] -= 1;
        PtJ base;
        to_mont(gx_raw, base.x, FQ);
        to_mont(gy_raw, base.y, FQ);
        base.z = FQ.one;
        for (int w = 0; w < 32; ++w) {
            PtJ cur = PT_ID;
            for (int j = 1; j < 256; ++j) {
                pt_add(cur, base, cur);
                table[w * 256 + j] = cur;
            }
            for (int k = 0; k < 8; ++k) pt_dbl(base, base);
        }
        table_init = true;
    }
    unsigned nt = std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > 4) nt = 4;
    if (n < 256) nt = 1;
    size_t chunk = (n + nt - 1) / nt;
    std::vector<std::thread> ths;
    for (unsigned t = 0; t < nt; ++t) {
        size_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) continue;
        ths.emplace_back([&, lo, hi]() {
            std::vector<uint8_t> buf(glen + 8);
            memcpy(buf.data(), genesis, glen);
            for (size_t i = lo; i < hi; ++i) {
                u64 idx = start + i;
                for (int j = 0; j < 8; ++j) buf[glen + j] = (uint8_t)(idx >> (8 * j));
                uint8_t hash[32];
                sha3_256(buf.data(), buf.size(), hash);
                u64 s[4];
                reduce_mod_r(hash, s);
                PtJ acc = PT_ID;
                for (int w = 0; w < 32; ++w) {
                    int limb = w / 8, off = (w % 8) * 8;
                    int d = (int)((s[limb] >> off) & 0xFF);
                    if (d) pt_add(acc, table[w * 256 + d], acc);
                }
                store_affine(acc, out + 64 * i);
            }
        });
    }
    for (auto& th : ths) th.join();
}

}  // extern "C"
