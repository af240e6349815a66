// K1: weight gradient of the 3x3x3 "same" convolution (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/block_conv.py::blocked_conv_a2o_dw and
// blocked_conv_o2a_dw (B7: the weight gradients of the half-offset conv
// pair, the o2a form recomputing the norm1 + leaky prologue) and
// blocked_conv_s2d_dw (B13: the weight gradient of the 27-tap conv). All
// three compute one function, which this kernel computes on dense NDHWC
// tensors:
//
//   dW[tap, ci, co] = sum_{b, v}  pro(x)[b, v + tap, ci] * g[b, v, co]
//
// with zero padding outside the volume applied AFTER the optional prologue
// pro(v) = bf16(leaky(v * scale[b, c] + shift[b, c])), the convention of
// B1's prologue (conv3d.cu). Inputs bf16, f32 accumulation, f32 output
// (27, ci, co).
//
// What bounds it: 2 * B*D*H*W * 27 * ci * co operations against
// 2 * B*D*H*W * (ci + co) bytes: bound by operations (dec1.conv1 at
// 4x128^3: 232 GFLOP, 0.23 ms at the bf16 tensor-core peak). This first
// version runs the products on the CUDA cores in f32. Each block owns one
// (tap, 32-ci, 64-co) tile of dW and one contiguous chunk of the flattened
// (b, voxel) reduction axis; it stages 64 voxels of pro(x) and g at a time
// in shared memory, every thread accumulates a 4 x 4 register tile over its
// share of the staged voxels, the block sums its threads' tiles in shared
// memory and adds the result to dW with atomicAdd. So the reduction across
// chunks runs in an order that changes from run to run (f32 sums of up to
// 8.4M products: relative differences ~1e-6 of max |dW|). Moving the
// product onto the tensor cores is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int CH = 64;   // voxels staged per step

struct Params {
  const __nv_bfloat16* x;  // (B, D, H, W, ci)
  const __nv_bfloat16* g;  // (B, D, H, W, co)
  const float* in_scale;   // (B, ci) prologue, or null
  const float* in_shift;
  float slope;
  float* dw;               // (27, ci, co), zeroed by the caller
  int D, H, W, ci, co;
  long long M;             // B * D * H * W
  long long chunk;         // voxels per block, a multiple of CH
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int TCI, int TCO>
__global__ void __launch_bounds__(NT) wgrad_kernel(const Params p) {
  constexpr int CO4 = TCO / 4;
  constexpr int SUBS = (TCI / 4) * CO4;  // 4x4 register tiles per dW tile
  constexpr int VG = NT / SUBS;          // voxel groups sharing the staging
  __shared__ float As[CH][TCI + 1];
  __shared__ float Gs[CH][TCO + 1];
  __shared__ float red[VG][TCI * TCO];
  __shared__ long long src[CH];  // element offset of x[b, v + tap, 0], or -1
  __shared__ int sb[CH];         // batch index of the staged voxel

  const int nci = (p.ci + TCI - 1) / TCI;
  const int nco = (p.co + TCO - 1) / TCO;
  int t = blockIdx.x;
  const int co0 = (t % nco) * TCO;
  t /= nco;
  const int ci0 = (t % nci) * TCI;
  const int tap = t / nci;
  const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
  const int HW = p.H * p.W;
  const long long nvox = (long long)p.D * HW;
  const bool pro = p.in_scale != nullptr;

  const int tid = threadIdx.x;
  const int sub = tid % SUBS;
  const int vg = tid / SUBS;
  const int ci_s = (sub / CO4) * 4;
  const int co_s = (sub % CO4) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const long long m_begin = (long long)blockIdx.y * p.chunk;
  const long long m_end = min(p.M, m_begin + p.chunk);
  for (long long m0 = m_begin; m0 < m_end; m0 += CH) {
    if (tid < CH) {
      const long long m = m0 + tid;
      long long off = -1;
      int bb = 0;
      if (m < m_end) {
        bb = (int)(m / nvox);
        const long long v = m - bb * nvox;
        const int z = (int)(v / HW);
        const int rem = (int)(v - (long long)z * HW);
        const int y = rem / p.W;
        const int xx = rem - y * p.W;
        const int zz = z + dz, yy = y + dy, xs = xx + dx;
        if (zz >= 0 && zz < p.D && yy >= 0 && yy < p.H && xs >= 0 && xs < p.W)
          off = ((long long)bb * nvox + (long long)zz * HW + (long long)yy * p.W + xs) *
                p.ci;
      }
      src[tid] = off;
      sb[tid] = bb;
    }
    __syncthreads();
    for (int i = tid; i < CH * TCI; i += NT) {
      const int v = i / TCI, k = i % TCI;
      const int c = ci0 + k;
      const long long off = src[v];
      float val = 0.f;
      if (off >= 0 && c < p.ci) {
        val = __bfloat162float(p.x[off + c]);
        if (pro) {
          const int bb = sb[v];
          val = fmaf(val, p.in_scale[(size_t)bb * p.ci + c],
                     p.in_shift[(size_t)bb * p.ci + c]);
          val = val >= 0.f ? val : p.slope * val;
          val = round_bf16(val);
        }
      }
      As[v][k] = val;
    }
    for (int i = tid; i < CH * TCO; i += NT) {
      const int v = i / TCO, n = i % TCO;
      const long long m = m0 + v;
      float val = 0.f;
      if (m < m_end && co0 + n < p.co)
        val = __bfloat162float(p.g[m * p.co + co0 + n]);
      Gs[v][n] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int v = vg; v < CH; v += VG) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[v][ci_s + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Gs[v][co_s + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[vg][(ci_s + i) * TCO + co_s + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < TCI * TCO; o += NT) {
    const int c = ci0 + o / TCO, n = co0 + o % TCO;
    if (c < p.ci && n < p.co) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < VG; ++k) s += red[k][o];
      atomicAdd(&p.dw[((size_t)tap * p.ci + c) * p.co + n], s);
    }
  }
}

template <int TCI, int TCO>
void launch(Params p, cudaStream_t stream) {
  const int tiles = 27 * ((p.ci + TCI - 1) / TCI) * ((p.co + TCO - 1) / TCO);
  // ~16 blocks per SM in all, each over a contiguous chunk of the voxels
  const long long want = (2112 + tiles - 1) / tiles;
  const long long steps = (p.M + CH - 1) / CH;
  const long long chunks = want < steps ? want : steps;
  p.chunk = ((steps + chunks - 1) / chunks) * CH;
  const long long nchunks = (p.M + p.chunk - 1) / p.chunk;
  dim3 grid(tiles, (unsigned)nchunks);
  wgrad_kernel<TCI, TCO><<<grid, NT, 0, stream>>>(p);
}

template <int TCI>
void launch_co(const Params& p, cudaStream_t s) {
  if (p.co >= 64)
    launch<TCI, 64>(p, s);
  else if (p.co >= 32)
    launch<TCI, 32>(p, s);
  else
    launch<TCI, 16>(p, s);
}

}  // namespace

extern "C" int fcd_conv3d_wgrad(const void* x, const void* g,
                                const float* in_scale, const float* in_shift,
                                float slope, float* dw, int B, int D, int H,
                                int W, int ci, int co, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.slope = slope;
  p.dw = dw;
  p.D = D;
  p.H = H;
  p.W = W;
  p.ci = ci;
  p.co = co;
  p.M = (long long)B * D * H * W;
  p.chunk = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ci >= 32)
    launch_co<32>(p, s);
  else if (ci >= 16)
    launch_co<16>(p, s);
  else
    launch_co<4>(p, s);
  return static_cast<int>(cudaGetLastError());
}
