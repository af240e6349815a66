// f32 products on the tensor cores as 3xTF32 (mma.sync m16n8k8 .tf32),
// shared by csrc/spatial_attn.cu (K3 / K4's f32 instances) and
// csrc/dsa_f32.cu (B5's f32 instances).
//
// Each f32 operand x is split into its TF32 high part hi = tf32(x) and the
// TF32 rounding of the rest lo = tf32(x - hi); a product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32 accumulators, the small terms
// first (a_lo.b_lo, about 2^-22 of a product, is dropped). Three TF32
// products for one f32 product: 495 / 3 = 165 TFLOP/s on an H100 SXM.
// A chain of many such products in one accumulator drifts more than
// IEEE f32 sums do, so callers keep chains short (a few k-steps) and add
// the chains' results in f32.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as its TF32 high part and the TF32 rounding of the rest
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], TF32 in, f32 accumulators
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (the m16n8 tile of rows m0 .. m0 + 15, columns n0 + 8 j .., j <
// nj) += A[m0 .., 0 .. k1) . B[0 .. k1, n0 ..) on 3xTF32 (k1 a multiple
// of 8), the f32 operands loaded one scalar a fragment element (3xTF32's
// split happens in registers, so no ldmatrix): A stored M x K (row m at
// A + m ap) or, with AKM, K x M; B stored K x N or, with BNK, N x K.
// Conflict-free shared-memory pitches: ap = 4 mod 8 (A M x K) or 8 mod 16
// (K x M); bp = 8 mod 16 (B K x N) or 4 mod 8 (N x K).
template <bool AKM, bool BNK, int MJ>
__device__ __forceinline__ void warp_mma_tf32(float (&acc)[MJ][4], int nj,
                                              const float* A, int ap, int m0,
                                              const float* B, int bp, int n0,
                                              int k1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < k1; k += 8) {
    float a[4];
    if constexpr (AKM) {
      const float* r0 = A + (k + t) * ap + m0 + g;
      const float* r1 = r0 + 4 * ap;
      a[0] = r0[0];
      a[1] = r0[8];
      a[2] = r1[0];
      a[3] = r1[8];
    } else {
      const float* r0 = A + (m0 + g) * ap + k + t;
      const float* r1 = r0 + 8 * ap;
      a[0] = r0[0];
      a[1] = r1[0];
      a[2] = r0[4];
      a[3] = r1[4];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split3(a[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      if (j >= nj) break;
      float b0, b1;
      if constexpr (BNK) {
        const float* r = B + (n0 + 8 * j + g) * bp + k + t;
        b0 = r[0];
        b1 = r[4];
      } else {
        const float* r = B + (k + t) * bp + n0 + 8 * j + g;
        b0 = r[0];
        b1 = r[4 * bp];
      }
      uint32_t bh0, bl0, bh1, bl1;
      split3(b0, bh0, bl0);
      split3(b1, bh1, bl1);
      mma1688(acc[j], al, bh0, bh1);
      mma1688(acc[j], ah, bl0, bl1);
      mma1688(acc[j], ah, bh0, bh1);
    }
  }
}

}  // namespace
