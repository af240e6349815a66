// The 16-bit operand type of a build, shared by csrc/dsa.cu (B5) and
// csrc/spatial_attn.cu (K3 / K4).
//
// h16 is bf16, or f16 where the source is compiled with -DFCD_F16:
// kernels/_build.py builds each of the two sources twice, into libdsa and
// libdsa_f16, libspatial_attn and libspatial_attn_f16. The JAX package
// runs B5 and B10 at whatever compute type the model has (their Pallas
// kernels are dtype-generic, fcd_tpu/kernels/dsa_attention.py:98-114 and
// spatial_attn.py:83-131), so a model that computes in f16 (ROADMAP C20)
// rounds at the same points as a bf16 one, to f16. Every product of the
// two sources is mma.sync m16n8k16 on two h16 operands with f32
// accumulators; pack2 rounds two f32 values to h16 (nearest even), the
// only conversion the kernels make besides to_h16 and h16_to_f.

#pragma once

#include <stdint.h>

#ifdef FCD_F16
#include <cuda_fp16.h>
#else
#include <cuda_bf16.h>
#endif

namespace {

#ifdef FCD_F16
typedef __half h16;
#define FCD_MMA16_TYPES "f16.f16"

__device__ __forceinline__ h16 to_h16(float v) { return __float2half_rn(v); }
__device__ __forceinline__ float h16_to_f(h16 v) { return __half2float(v); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
#else
typedef __nv_bfloat16 h16;
#define FCD_MMA16_TYPES "bf16.bf16"

__device__ __forceinline__ h16 to_h16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float h16_to_f(h16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
#endif

// d[16 x 8] += a[16 x 16] . b[16 x 8], h16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32." FCD_MMA16_TYPES ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
