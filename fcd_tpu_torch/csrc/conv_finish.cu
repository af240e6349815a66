// The finishing pass of B1's row-parallel split (Hopper, sm_90a).
//
// Under tensor parallelism (fcd_tpu/parallel/tp.py) a row-parallel 3x3x3
// conv runs B1's partial instance (csrc/conv3d.cu, fcd_conv3d_partial) on
// each rank's slice of the input channels; the ranks' f32 partials are
// summed by an all-reduce, and this pass finishes the sum s as B1's
// epilogue finishes its accumulators on one device (the Pallas kernel it
// stands beside is fcd_tpu/kernels/block_conv.py::_fused8_call):
//
//   y[b, v, c]   = bf16(s[b, v, c])
//   sum[b, c]    = sum_v s[b, v, c]           (f32, before the rounding)
//   sumsq[b, c]  = sum_v s[b, v, c]^2
//
// The statistics are taken from the summed f32 values: the sum of the
// ranks' partial squares is not the square of their sum, so they are never
// all-reduced in place of the output.
//
// Design: a block owns a run of consecutive voxels of one batch item and
// every channel: TC = min(C, 256) threads across the channels (a warp reads
// 32 consecutive f32, 128 bytes), RB = 256 / TC rows of them down the
// voxels, each thread holding the running sums of its ceil(C / TC)
// channels in registers. The RB rows' sums are added in row order through
// shared memory and written once, at (run, b, c) of a (runs, B, C)
// buffer; the wrapper (kernels/conv_finish.py) adds the runs in a fixed
// order. No atomics: the same bits from run to run.
//
// What bounds it: bytes. It reads 4 and writes 2 bytes an element (at
// enc1's 128^3 x 16 that is 192 MiB, about 58 us at 3.35 TB/s), and does
// three f32 operations an element; the wrapper picks enough runs to put
// about four blocks on each of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAXC = 4;  // channels a thread: C up to 1024

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(NT)
    conv_finish_kernel(const float* __restrict__ s, bf16* __restrict__ y,
                       float* __restrict__ psum, float* __restrict__ psq,
                       int nvox, int C, int rows) {
  extern __shared__ float red[];  // (2, RB, C)
  const int tc = threadIdx.x, tr = threadIdx.y;
  const int TC = blockDim.x, RB = blockDim.y;
  const int run = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const size_t v0 = (size_t)run * rows;
  const size_t v1 = min((size_t)nvox, v0 + rows);
  const float* src = s + (size_t)b * nvox * C;
  bf16* dst = y + (size_t)b * nvox * C;
  float s1[MAXC], s2[MAXC];
#pragma unroll
  for (int k = 0; k < MAXC; ++k) s1[k] = s2[k] = 0.f;
  for (size_t v = v0 + tr; v < v1; v += RB) {
#pragma unroll
    for (int k = 0; k < MAXC; ++k) {
      const int c = tc + k * TC;
      if (c >= C) break;
      const float t = src[v * C + c];
      dst[v * C + c] = __float2bfloat16(t);
      s1[k] += t;
      s2[k] += t * t;
    }
  }
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    const int c = tc + k * TC;
    if (c >= C) break;
    red[(size_t)tr * C + c] = s1[k];
    red[(size_t)(RB + tr) * C + c] = s2[k];
  }
  __syncthreads();
  if (tr != 0) return;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    const int c = tc + k * TC;
    if (c >= C) break;
    float a = 0.f, q = 0.f;
    for (int r = 0; r < RB; ++r) {
      a += red[(size_t)r * C + c];
      q += red[(size_t)(RB + r) * C + c];
    }
    const size_t at = ((size_t)run * B + b) * C + c;
    psum[at] = a;
    psq[at] = q;
  }
}

}  // namespace

// s: f32 (B, nvox, C); y: bf16, the same shape; psum, psq: f32 (runs, B, C)
// partial sums of `rows` voxels a run.
extern "C" int fcd_conv_finish(const float* s, void* y, float* psum,
                               float* psq, int B, int nvox, int C, int rows,
                               int runs, void* stream) {
  if (C < 1 || C > MAXC * NT) return static_cast<int>(cudaErrorInvalidValue);
  const int tc = C < NT ? C : NT;
  const int rb = NT / tc;
  const size_t smem = 2 * (size_t)rb * C * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv_finish_kernel<<<dim3(runs, B), dim3(tc, rb), smem, st>>>(
      s, static_cast<bf16*>(y), psum, psq, nvox, C, rows);
  return static_cast<int>(cudaGetLastError());
}
