// B15: the last decoder block's finale fused with the 1x1 segmentation
// head (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/block_conv.py::fused_finale_head (pallas_call
// :1578, kernel body :1514-1543). Per voxel of (B, N) and output o:
//
//   t      = ((y2[c] * s2[b, c] + b2[b, c]) + r[c] * sr[b, c]) + br[b, c]
//   a[c]   = bf16(t >= 0 ? t : slope * t)
//   out[o] = round(sum_c a[c] * w[c, o] + bias[o])
//
// t in f32 in the TPU kernel's association order (the multiplies and adds
// are __fmul_rn / __fadd_rn, so no contraction into fma changes t), the
// activation rounded to bf16, the products with the bf16 head weights
// summed in f32 (a product of two bf16 values is exact in f32), the f32
// bias added before the single rounding to the output dtype (bf16 or f32).
// Only the order of the sum over c differs from the plain version.
//
// What bounds it: bytes. Per voxel it reads 2C bf16 values (y2, r) and
// writes O, against ~(5 + 2 O) C operations: at C = 16, O = 2 that is
// 68 bytes for ~144 operations, far below the card's ~295 operations per
// byte. So the design is one thread per voxel, neighbouring threads on
// neighbouring voxels: each thread reads its voxel's C channels of y2 and
// r as 16-byte vectors (a warp reads one contiguous run of each), keeps
// the O sums in registers, and writes its O outputs next to its
// neighbours'. The block's affines and the C x O weights sit in shared
// memory, loaded once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_O = 8;

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    finale_head_kernel(const __nv_bfloat16* __restrict__ y2,
                       const __nv_bfloat16* __restrict__ r,
                       const float* __restrict__ s2,
                       const float* __restrict__ b2,
                       const float* __restrict__ sr,
                       const float* __restrict__ br,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int64_t N, int C, int O, float slope) {
  extern __shared__ float smem[];
  float* s_s2 = smem;
  float* s_b2 = s_s2 + C;
  float* s_sr = s_b2 + C;
  float* s_br = s_sr + C;
  float* s_w = s_br + C;          // (C, O)
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C; i += NT) {
    s_s2[i] = s2[(int64_t)b * C + i];
    s_b2[i] = b2[(int64_t)b * C + i];
    s_sr[i] = sr[(int64_t)b * C + i];
    s_br[i] = br[(int64_t)b * C + i];
  }
  for (int i = threadIdx.x; i < C * O; i += NT) s_w[i] = w[i];
  __syncthreads();

  const int64_t v = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (v >= N) return;
  const int64_t vox = (int64_t)b * N + v;
  const uint4* yp = reinterpret_cast<const uint4*>(y2 + vox * C);
  const uint4* rp = reinterpret_cast<const uint4*>(r + vox * C);
  float acc[MAX_O];
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) acc[o] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 8) {
    const uint4 yv = yp[c0 / 8];
    const uint4 rv = rp[c0 / 8];
    const __nv_bfloat16* ya = reinterpret_cast<const __nv_bfloat16*>(&yv);
    const __nv_bfloat16* ra = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      float t = __fadd_rn(__fmul_rn(__bfloat162float(ya[j]), s_s2[c]),
                          s_b2[c]);
      t = __fadd_rn(t, __fmul_rn(__bfloat162float(ra[j]), s_sr[c]));
      t = __fadd_rn(t, s_br[c]);
      t = t >= 0.f ? t : __fmul_rn(slope, t);
      const float a = __bfloat162float(__float2bfloat16_rn(t));
      const float* wc = s_w + c * O;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < O) acc[o] = __fadd_rn(acc[o], __fmul_rn(a, wc[o]));
    }
  }
  T* op = out + vox * O;
#pragma unroll
  for (int o = 0; o < MAX_O; ++o)
    if (o < O)
      op[o] = from_f32<T>(bias != nullptr ? __fadd_rn(acc[o], bias[o])
                                          : acc[o]);
}

}  // namespace

// y2, r: (B, N, C) bf16 with C a multiple of 8; s2, b2, sr, br: (B, C) f32;
// w: (C, O) f32 holding bf16 values, O <= 8; bias: (O,) f32 or NULL;
// out: (B, N, O) bf16 (out_bf16 = 1) or f32.
extern "C" int fcd_finale_head(const void* y2, const void* r, const void* s2,
                               const void* b2, const void* sr, const void* br,
                               const void* w, const void* bias, void* out,
                               int out_bf16, int B, int64_t N, int C, int O,
                               float slope, void* stream) {
  if (C % 8 != 0 || O < 1 || O > MAX_O)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((N + NT - 1) / NT), B);
  const size_t shmem = sizeof(float) * (4 * C + C * O);
  const auto* y = static_cast<const __nv_bfloat16*>(y2);
  const auto* rr = static_cast<const __nv_bfloat16*>(r);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (out_bf16)
    finale_head_kernel<__nv_bfloat16><<<grid, NT, shmem, s>>>(
        y, rr, f(s2), f(b2), f(sr), f(br), f(w), f(bias),
        static_cast<__nv_bfloat16*>(out), N, C, O, slope);
  else
    finale_head_kernel<float><<<grid, NT, shmem, s>>>(
        y, rr, f(s2), f(b2), f(sr), f(br), f(w), f(bias),
        static_cast<float*>(out), N, C, O, slope);
  return static_cast<int>(cudaGetLastError());
}
