// B1: 3x3x3 "same" convolution of the eval residual blocks (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/block_conv.py::_fused8_call (the Pallas kernel
// behind blocked_conv_a2o, blocked_conv_a2o_multi and blocked_conv_o2a).
// It computes the op's function on dense NDHWC tensors; the TPU's s2d and
// half-offset layouts exist only to fill its 128-lane matrix unit and are
// not carried over.
//
//   y[b, v, o] = sum_parts sum_tap sum_c  pro(x_p[b, v + tap, c]) * w_p[tap, c, o]
//
// with zero padding outside the volume. Options, as flags of one kernel:
//   * a second input part with its own weights (the decoder's concat is
//     never materialised: the kernel sums the two parts' products);
//   * a prologue on part 0: pro(v) = bf16(leaky(v * scale[b, c] + shift[b, c]))
//     (norm1's affine and the activation fused into conv2's loads); taps
//     outside the volume read 0 AFTER the prologue, as zero padding of the
//     activated tensor;
//   * a 1x1 shortcut output r = sum_p x_p[b, v, :] @ wr_p from the centre
//     tap's reads;
//   * per-(b, o) sum and sum of squares of the f32 results of y and r (the
//     next instance norm's statistics): each block writes its partial sums
//     once, at (voxel block, b, o) of a (blocks, B, cout) buffer, and the
//     wrapper adds them over the blocks in a fixed order, so the statistics,
//     and the forward after them, are the same bits from run to run.
//
// Inputs bf16, f32 accumulation, bf16 outputs, f32 statistics.
//
// What bounds it: at the main path's shapes the conv does 27*Cin*Cout*2
// operations per voxel against ~2*(Cin+Cout) bytes, far above the card's
// ~295 operations per byte, so it is bound by operations. This first
// version is an implicit GEMM on the CUDA cores in f32 (M = voxels,
// N = output channels, K = 27 taps x input channels): each block keeps a
// 64-voxel x BK-channel tile of the (prologued) input and a BK x BN weight
// tile in shared memory and every thread accumulates a 4 x TN register
// tile, so each input value loaded from L2 feeds BN products. Moving the
// inner product onto the tensor cores (wgmma) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output voxels per block
constexpr int BK = 32;   // input channels per k-step
constexpr int NT = 256;  // threads per block

struct Part {
  const __nv_bfloat16* x;   // (B, D, H, W, c)
  const __nv_bfloat16* w;   // (27, c, cout)
  const __nv_bfloat16* wr;  // (c, cout) shortcut weights, or null
  int c;
};

struct Params {
  Part part[2];
  int nparts;
  const float* in_scale;  // (B, c of part 0) prologue, or null
  const float* in_shift;
  float slope;
  __nv_bfloat16* y;       // (B, D, H, W, cout)
  __nv_bfloat16* r;       // (B, D, H, W, cout) shortcut output, or null
  float* ysum;            // (voxel blocks, B, cout) partial statistics, or null
  float* ysq;
  float* rsum;
  float* rsq;
  int D, H, W, cout;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int TN>
__device__ void block_stats(const float (&acc)[4][TN], int m0, int tm, int tn,
                            int n0, int nvox, int cout, int b,
                            float (*red)[16][16 * TN], float* sum, float* sq) {
  constexpr int BN = 16 * TN;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + 4 * tm + i < nvox) {
        s += acc[i][j];
        q += acc[i][j] * acc[i][j];
      }
    }
    red[0][tm][tn + 16 * j] = s;
    red[1][tm][tn + 16 * j] = q;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < BN; n += NT) {
    if (n0 + n < cout) {
      float s = 0.f, q = 0.f;
      for (int t = 0; t < 16; ++t) {
        s += red[0][t][n];
        q += red[1][t][n];
      }
      const size_t at = ((size_t)blockIdx.x * gridDim.z + b) * cout + n0 + n;
      sum[at] = s;
      sq[at] = q;
    }
  }
  __syncthreads();
}

template <int TN>
__global__ void __launch_bounds__(NT) conv3d_kernel(const Params p) {
  constexpr int BN = 16 * TN;
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN];
  __shared__ float Rs[BK][BN];
  __shared__ float red[2][16][BN];

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int HW = p.H * p.W;
  const int nvox = p.D * HW;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tn = tid & 15;  // output channels n0 + tn + 16 j
  const int tm = tid >> 4;  // output voxels m0 + 4 tm + i
  const bool want_r = p.r != nullptr;

  // loader: channel lk of voxels m0 + lm + 8 j
  const int lk = tid % BK;
  const int lm = tid / BK;
  int vz[8], vy[8], vx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = m0 + lm + 8 * j;
    if (m < nvox) {
      vz[j] = m / HW;
      const int rem = m - vz[j] * HW;
      vy[j] = rem / p.W;
      vx[j] = rem - vy[j] * p.W;
    } else {
      vz[j] = -4;  // every tap falls outside the volume
      vy[j] = 0;
      vx[j] = 0;
    }
  }

  float acc[4][TN];
  float racc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      racc[i][j] = 0.f;
    }

  for (int pi = 0; pi < p.nparts; ++pi) {
    const Part pt = p.part[pi];
    const int C = pt.c;
    const __nv_bfloat16* xb = pt.x + (size_t)b * nvox * C;
    const bool pro = pi == 0 && p.in_scale != nullptr;
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9 - 1;
      const int dy = (tap / 3) % 3 - 1;
      const int dx = tap % 3 - 1;
      const bool centre = want_r && tap == 13;
      for (int c0 = 0; c0 < C; c0 += BK) {
        const int kc = min(BK, C - c0);
        const int c = c0 + lk;
        float sc = 1.f, sh = 0.f;
        if (pro && lk < kc) {
          sc = p.in_scale[(size_t)b * C + c];
          sh = p.in_shift[(size_t)b * C + c];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int z = vz[j] + dz, y = vy[j] + dy, x = vx[j] + dx;
          float v = 0.f;
          if (lk < kc && z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 &&
              x < p.W) {
            v = __bfloat162float(xb[((size_t)z * HW + (size_t)y * p.W + x) * C + c]);
            if (pro) {
              v = fmaf(v, sc, sh);
              v = v >= 0.f ? v : p.slope * v;
              v = round_bf16(v);
            }
          }
          As[lk][lm + 8 * j] = v;
        }
        for (int i = tid; i < BK * BN; i += NT) {
          const int k = i / BN, n = i % BN;
          float wv = 0.f, rv = 0.f;
          if (k < kc && n0 + n < p.cout) {
            wv = __bfloat162float(pt.w[((size_t)tap * C + c0 + k) * p.cout + n0 + n]);
            if (centre)
              rv = __bfloat162float(pt.wr[(size_t)(c0 + k) * p.cout + n0 + n]);
          }
          Ws[k][n] = wv;
          if (centre) Rs[k][n] = rv;
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
        if (centre) {
          for (int k = 0; k < kc; ++k) {
            float a[4], w[TN];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][4 * tm + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) w[j] = Rs[k][tn + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                racc[i][j] = fmaf(a[i], w[j], racc[i][j]);
          }
        }
        __syncthreads();
      }
    }
  }

  const size_t obase = (size_t)b * nvox;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= nvox) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + 16 * j;
      if (n >= p.cout) continue;
      p.y[(obase + m) * p.cout + n] = __float2bfloat16(acc[i][j]);
      if (want_r) p.r[(obase + m) * p.cout + n] = __float2bfloat16(racc[i][j]);
    }
  }
  if (p.ysum != nullptr)
    block_stats<TN>(acc, m0, tm, tn, n0, nvox, p.cout, b, red, p.ysum, p.ysq);
  if (want_r && p.rsum != nullptr)
    block_stats<TN>(racc, m0, tm, tn, n0, nvox, p.cout, b, red, p.rsum, p.rsq);
}

template <int TN>
void launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int BN = 16 * TN;
  const int nvox = p.D * p.H * p.W;
  dim3 grid((nvox + BM - 1) / BM, (p.cout + BN - 1) / BN, B);
  conv3d_kernel<TN><<<grid, NT, 0, stream>>>(p);
}

}  // namespace

extern "C" int fcd_conv3d(const void* x0, const void* w0, const void* wr0,
                          int c0, const void* x1, const void* w1,
                          const void* wr1, int c1, int nparts,
                          const float* in_scale, const float* in_shift,
                          float slope, void* y, void* r, float* ysum,
                          float* ysq, float* rsum, float* rsq, int B, int D,
                          int H, int W, int cout, void* stream) {
  Params p;
  p.part[0] = {static_cast<const __nv_bfloat16*>(x0),
               static_cast<const __nv_bfloat16*>(w0),
               static_cast<const __nv_bfloat16*>(wr0), c0};
  p.part[1] = {static_cast<const __nv_bfloat16*>(x1),
               static_cast<const __nv_bfloat16*>(w1),
               static_cast<const __nv_bfloat16*>(wr1), c1};
  p.nparts = nparts;
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.slope = slope;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.r = static_cast<__nv_bfloat16*>(r);
  p.ysum = ysum;
  p.ysq = ysq;
  p.rsum = rsum;
  p.rsq = rsq;
  p.D = D;
  p.H = H;
  p.W = W;
  p.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % 64 == 0)
    launch<4>(p, B, s);
  else if (cout % 32 == 0)
    launch<2>(p, B, s);
  else
    launch<1>(p, B, s);
  return static_cast<int>(cudaGetLastError());
}
