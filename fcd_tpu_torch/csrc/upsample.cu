// B4: k2 s2 transposed convolution, the decoders' upsample (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/upsample.py::upsample_s2d_pad (and the gated-off
// upsample_s2d_pallas). It computes the op's function on dense NDHWC
// tensors:
//
//   out[b, 2z+a, 2y+c, 2x+e, o] = bias[o] + sum_i x[b, z, y, x, i] * wm[i, q*Co + o]
//
// with q = 4a + 2c + e and wm the (Ci, 8*Co) matrix the wrapper builds from
// the flax (2, 2, 2, Ci, Co) kernel: wm[i, q*Co + o] = kernel[1-a, 1-c, 1-e, i, o]
// (lax.conv_transpose correlates the stride-dilated input with the kernel as
// it is, so output parity a reads tap 1-a). Each coarse voxel feeds exactly
// one fine voxel per parity, so the op is one GEMM (M = coarse voxels,
// K = Ci, N = 8*Co) whose epilogue scatters the N axis onto the 2x2x2
// fine block.
//
// Inputs bf16, f32 accumulation, bf16 output. What bounds it: 2*Ci
// operations per output element against 2 bytes written, ~Ci operations
// per byte (32..256 on this path), under the card's ~295 operations per
// byte, so it is bound by the bytes it writes. The design keeps the GEMM
// tiled in shared memory (64 coarse voxels x 32 channels of x, a 32 x 64
// tile of wm) so x and wm are read once per tile, and writes each fine
// row's channels with neighbouring threads on neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BK = 32;
constexpr int NT = 256;

template <int TN>
__global__ void __launch_bounds__(NT)
    upsample_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wm,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int D, int H, int W,
                    int ci, int co) {
  constexpr int BN = 16 * TN;
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN];
  const int b = blockIdx.z;
  const int n8 = 8 * co;
  const int n0 = blockIdx.y * BN;
  const int HW = H * W;
  const int nvox = D * HW;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tn = tid & 15;
  const int tm = tid >> 4;
  const int lk = tid % BK;
  const int lm = tid / BK;
  const __nv_bfloat16* xb = x + (size_t)b * nvox * ci;

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += BK) {
    const int kc = min(BK, ci - c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + lm + 8 * j;
      float v = 0.f;
      if (lk < kc && m < nvox) v = __bfloat162float(xb[(size_t)m * ci + c0 + lk]);
      As[lk][lm + 8 * j] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      float wv = 0.f;
      if (k < kc && n0 + n < n8) wv = __bfloat162float(wm[(size_t)(c0 + k) * n8 + n0 + n]);
      Ws[k][n] = wv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float a[4], w[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][4 * tm + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = Ws[k][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int H2 = 2 * H, W2 = 2 * W;
  const size_t fine_base = (size_t)b * (2 * D) * H2 * W2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= nvox) continue;
    const int z = m / HW;
    const int rem = m - z * HW;
    const int y = rem / W;
    const int xx = rem - y * W;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n >= n8) continue;
      const int q = n / co, o = n - q * co;
      const int a = q >> 2, c = (q >> 1) & 1, e = q & 1;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[o];
      const size_t fv = fine_base + ((size_t)(2 * z + a) * H2 + (2 * y + c)) * W2 + (2 * xx + e);
      out[fv * co + o] = __float2bfloat16(v);
    }
  }
}

template <int TN>
void launch(const void* x, const void* wm, const float* bias, void* out, int B,
            int D, int H, int W, int ci, int co, cudaStream_t s) {
  constexpr int BN = 16 * TN;
  const int nvox = D * H * W;
  dim3 grid((nvox + BM - 1) / BM, (8 * co + BN - 1) / BN, B);
  upsample_kernel<TN><<<grid, NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wm), bias,
      static_cast<__nv_bfloat16*>(out), D, H, W, ci, co);
}

}  // namespace

extern "C" int fcd_upsample(const void* x, const void* wm, const float* bias,
                            void* out, int B, int D, int H, int W, int ci,
                            int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((8 * co) % 64 == 0)
    launch<4>(x, wm, bias, out, B, D, H, W, ci, co, s);
  else
    launch<1>(x, wm, bias, out, B, D, H, W, ci, co, s);
  return static_cast<int>(cudaGetLastError());
}
