// Complete projective Pallas-curve formulas on register words (a = 0, b = 5).
//
// Line-for-line the list-form formula of halo_accumulation_tpu/ops/limbs.py
// (padd_list: RCB16 algorithm 7 with b3 = 15; pdbl.cu splits pdbl_list,
// algorithm 9, across four threads), which the torch twins in
// ops/cuda_kernels.py compute with the same field operations on the same
// operands: every coordinate is the twin's value mod q, so the canonical
// limbs a kernel stores equal FQ.canon of the twin's.
// Complete formulas have no branches: P == Q, P == -Q and the identity
// (0 : 1 : 0) take the same path.
#pragma once
#include "field.cuh"

namespace halo {

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt identity() { return Pt{fe_word(0), fe_word(1), fe_word(0)}; }

__device__ __forceinline__ Pt padd(const Pt& P, const Pt& Q) {
  const Fe t0 = mul(P.x, Q.x);
  const Fe t1 = mul(P.y, Q.y);
  const Fe t2 = mul(P.z, Q.z);
  const Fe t3 = sub(mul(add(P.x, P.y), add(Q.x, Q.y)), add(t0, t1));
  const Fe t4 = sub(mul(add(P.y, P.z), add(Q.y, Q.z)), add(t1, t2));
  const Fe w = sub(mul(add(P.x, P.z), add(Q.x, Q.z)), add(t0, t2));
  const Fe t2b = mul_small(t2, 15u);
  const Fe wb = mul_small(w, 15u);
  const Fe t0b = add(add(t0, t0), t0);
  const Fe z3s = add(t1, t2b);
  const Fe t1b = sub(t1, t2b);
  Pt R;
  R.x = sub(mul(t3, t1b), mul(t4, wb));
  R.y = add(mul(t1b, z3s), mul(wb, t0b));
  R.z = add(mul(z3s, t4), mul(t0b, t3));
  return R;
}

__device__ __forceinline__ Pt load_pt(const int64_t* x, const int64_t* y, const int64_t* z,
                                      int64_t stride, int64_t col) {
  return Pt{load_fe(x, stride, col), load_fe(y, stride, col), load_fe(z, stride, col)};
}

__device__ __forceinline__ void store_pt(int64_t* x, int64_t* y, int64_t* z, int64_t stride,
                                         int64_t col, const Pt& P) {
  store_fe(x, stride, col, P.x);
  store_fe(y, stride, col, P.y);
  store_fe(z, stride, col, P.z);
}

}  // namespace halo
