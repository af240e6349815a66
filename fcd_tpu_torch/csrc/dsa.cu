// B5: fused eval dual self-attention (DSA, sa_type 'parallel'), two kernels
// (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/dsa_attention.py::dsa_fused (its phase A and
// phase B Pallas kernels). Both phases fuse the pos-embed add and the
// LayerNorm (eps given) into their token loads:
//   t   = x + pe,   xln = bf16(LN(t) * ln_scale + ln_bias)
//   q, k, v_ca, v_sa = xln @ w[0..3]          (f32 accumulation)
// Phase A reduces over token tiles (one block per tile; each block writes
// its partial sums once, at (tile, b) of buffers with a leading tiles axis,
// and the wrapper adds them over the tiles in a fixed order, so the sums are
// the same bits from run to run):
//   qk = q^T k (C x C), q2 = sum q^2, k2 = sum k^2 (C),
//   kp = bf16(k)^T ef, vp = bf16(v_sa)^T ef (C x P).
// The per-head C x C softmax between the phases is left to PyTorch, as the
// JAX package leaves it to XLA. Phase B maps over token tiles:
//   out_ca[n, c] = sum_{d in head(c)} bf16(v_ca)[n, d] * abig[d, c]
//   s_h[n, p]    = softmax_p(sum_{c in h} qn[n, c] * kpt[c, p]),  qn = bf16(q * qnorm)
//   out_sa[n, c] = sum_p bf16(s_h)[n, p] * vp[c, p]              (c in head h)
//   y[n, c]      = bf16(t[n, c] + gamma[c] * (out_ca + out_sa))
// abig is block diagonal (the per-head channel attention, transposed) and
// kpt carries temperature2; the TPU kernel multiplies by the zero blocks,
// this kernel skips them (the sums are the same).
//
// What bounds it: per token ~2*C*(3C + 2P) operations (phase A) and
// ~2*C*(2C + C/h + 2P) (phase B) against ~6*C bytes (bf16 tokens in and
// out, f32 pos-embed): at C = 32..256 both sides are small, and at this
// slice's sizes the kernels are bound by operations on the CUDA cores and by
// their many small steps. The design keeps a whole token tile (T*C <= 4096
// values) and every per-token intermediate in shared memory, so tokens are
// read from device memory once per phase and written once, and runs the
// small products on the CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (pos-embed +) LayerNorm of a tile of T tokens: base = x + pe (f32, if
// wanted), xs = bf16-rounded normalised tokens. Tokens past N read as 0.
__device__ void ln_tile(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ pe,
                        const float* __restrict__ lns,
                        const float* __restrict__ lnb, float eps, int b,
                        int n0, int T, int N, int C, float* xs, float* base) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += NWARP) {
    const int n = n0 + t;
    if (n >= N) {
      for (int c = lane; c < C; c += 32) {
        xs[t * C + c] = 0.f;
        if (base != nullptr) base[t * C + c] = 0.f;
      }
      continue;
    }
    const __nv_bfloat16* xr = x + ((size_t)b * N + n) * C;
    float s = 0.f, q = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = __bfloat162float(xr[c]);
      if (pe != nullptr) v += pe[(size_t)n * C + c];
      xs[t * C + c] = v;
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mu = s / C;
    const float var = fmaxf(q / C - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float v = xs[t * C + c];
      if (base != nullptr) base[t * C + c] = v;
      xs[t * C + c] = round_bf16((v - mu) * rstd * lns[c] + lnb[c]);
    }
  }
}

// phase A: one block per tile of T tokens of batch b
__global__ void __launch_bounds__(NT)
    dsa_phase_a(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pe,
                const float* __restrict__ lns, const float* __restrict__ lnb,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ ef, float* __restrict__ qk,
                float* __restrict__ q2, float* __restrict__ k2,
                float* __restrict__ kp, float* __restrict__ vp, int N, int C,
                int P, int T, float eps) {
  extern __shared__ float smem[];
  float* xs = smem;          // T*C
  float* qs = xs + T * C;    // T*C
  float* ks = qs + T * C;    // T*C
  float* vs = ks + T * C;    // T*C
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * T;
  const size_t CC = (size_t)C * C;
  const size_t tb = (size_t)blockIdx.x * gridDim.y + b;  // partials' row

  ln_tile(x, pe, lns, lnb, eps, b, n0, T, N, C, xs, nullptr);
  __syncthreads();

  const __nv_bfloat16* wq = w;
  const __nv_bfloat16* wk = w + CC;
  const __nv_bfloat16* wv = w + 3 * CC;  // v_sa slot of the parallel layout
  for (int i = threadIdx.x; i < T * C; i += NT) {
    const int t = i / C, c = i % C;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int k = 0; k < C; ++k) {
      const float a = xs[t * C + k];
      dq = fmaf(a, __bfloat162float(wq[(size_t)k * C + c]), dq);
      dk = fmaf(a, __bfloat162float(wk[(size_t)k * C + c]), dk);
      dv = fmaf(a, __bfloat162float(wv[(size_t)k * C + c]), dv);
    }
    qs[i] = dq;
    ks[i] = dk;
    vs[i] = round_bf16(dv);
  }
  __syncthreads();

  const int tv = min(T, N - n0);  // valid tokens of this tile
  for (int i = threadIdx.x; i < C * C; i += NT) {
    const int r = i / C, c = i % C;
    float s = 0.f;
    for (int t = 0; t < tv; ++t) s = fmaf(qs[t * C + r], ks[t * C + c], s);
    qk[tb * CC + i] = s;
  }
  for (int c = threadIdx.x; c < C; c += NT) {
    float sq = 0.f, sk = 0.f;
    for (int t = 0; t < tv; ++t) {
      sq = fmaf(qs[t * C + c], qs[t * C + c], sq);
      sk = fmaf(ks[t * C + c], ks[t * C + c], sk);
    }
    q2[tb * C + c] = sq;
    k2[tb * C + c] = sk;
  }
  for (int i = threadIdx.x; i < C * P; i += NT) {
    const int c = i / P, p = i % P;
    float sk = 0.f, sv = 0.f;
    for (int t = 0; t < tv; ++t) {
      const float e = __bfloat162float(ef[(size_t)(n0 + t) * P + p]);
      sk = fmaf(round_bf16(ks[t * C + c]), e, sk);
      sv = fmaf(vs[t * C + c], e, sv);
    }
    kp[tb * C * P + i] = sk;
    vp[tb * C * P + i] = sv;
  }
}

// phase B: one block per tile of T tokens of batch b
__global__ void __launch_bounds__(NT)
    dsa_phase_b(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pe,
                const float* __restrict__ lns, const float* __restrict__ lnb,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ qnorm,
                const __nv_bfloat16* __restrict__ abig,
                const __nv_bfloat16* __restrict__ kpt,
                const __nv_bfloat16* __restrict__ vp,
                const float* __restrict__ gamma, __nv_bfloat16* __restrict__ out,
                int N, int C, int P, int heads, int T, float eps) {
  extern __shared__ float smem[];
  float* xs = smem;            // T*C normalised tokens
  float* base = xs + T * C;    // T*C residual base x + pe
  float* vca = base + T * C;   // T*C
  float* qn = vca + T * C;     // T*C
  float* acc = qn + T * C;     // T*C
  float* sm = acc + T * C;     // T*P
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * T;
  const int ch = C / heads;
  const size_t CC = (size_t)C * C;
  const __nv_bfloat16* wq = w;
  const __nv_bfloat16* wv = w + 2 * CC;  // v_ca slot
  const __nv_bfloat16* ab = abig + (size_t)b * CC;
  const __nv_bfloat16* kb = kpt + (size_t)b * C * P;
  const __nv_bfloat16* vb = vp + (size_t)b * C * P;

  ln_tile(x, pe, lns, lnb, eps, b, n0, T, N, C, xs, base);
  __syncthreads();

  for (int i = threadIdx.x; i < T * C; i += NT) {
    const int t = i / C, c = i % C;
    float dq = 0.f, dv = 0.f;
    for (int k = 0; k < C; ++k) {
      const float a = xs[t * C + k];
      dq = fmaf(a, __bfloat162float(wq[(size_t)k * C + c]), dq);
      dv = fmaf(a, __bfloat162float(wv[(size_t)k * C + c]), dv);
    }
    qn[i] = round_bf16(dq * qnorm[(size_t)b * C + c]);
    vca[i] = round_bf16(dv);
  }
  __syncthreads();

  // channel attention: only the head's diagonal block of abig is non-zero
  for (int i = threadIdx.x; i < T * C; i += NT) {
    const int t = i / C, c = i % C;
    const int d0 = (c / ch) * ch;
    float s = 0.f;
    for (int d = d0; d < d0 + ch; ++d)
      s = fmaf(vca[t * C + d], __bfloat162float(ab[(size_t)d * C + c]), s);
    acc[i] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = 0; h < heads; ++h) {
    const int c0 = h * ch;
    for (int i = threadIdx.x; i < T * P; i += NT) {
      const int t = i / P, p = i % P;
      float s = 0.f;
      for (int c = c0; c < c0 + ch; ++c)
        s = fmaf(qn[t * C + c], __bfloat162float(kb[(size_t)c * P + p]), s);
      sm[i] = s;
    }
    __syncthreads();
    for (int t = warp; t < T; t += NWARP) {
      float mx = -INFINITY;
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, sm[t * P + p]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) {
        const float e = expf(sm[t * P + p] - mx);
        sm[t * P + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float inv = 1.f / sum;
      for (int p = lane; p < P; p += 32) sm[t * P + p] = round_bf16(sm[t * P + p] * inv);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * ch; i += NT) {
      const int t = i / ch, c = c0 + i % ch;
      float s = 0.f;
      for (int p = 0; p < P; ++p)
        s = fmaf(sm[t * P + p], __bfloat162float(vb[(size_t)c * P + p]), s);
      acc[t * C + c] += s;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < T * C; i += NT) {
    const int t = i / C, c = i % C;
    const int n = n0 + t;
    if (n >= N) continue;
    out[((size_t)b * N + n) * C + c] =
        __float2bfloat16(base[i] + gamma[c] * acc[i]);
  }
}

int tile_tokens(int C) { return C >= 4096 ? 1 : 4096 / C; }

}  // namespace

extern "C" int fcd_dsa_phase_a(const void* x, const float* pe, const float* lns,
                               const float* lnb, const void* w, const void* ef,
                               float* qk, float* q2, float* k2, float* kp,
                               float* vp, int B, int N, int C, int P,
                               float eps, void* stream) {
  const int T = tile_tokens(C);
  const size_t smem = (size_t)4 * T * C * sizeof(float);
  cudaFuncSetAttribute(dsa_phase_a, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((N + T - 1) / T, B);
  dsa_phase_a<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), pe, lns, lnb,
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(ef), qk, q2, k2, kp, vp, N, C, P, T,
      eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fcd_dsa_phase_b(const void* x, const float* pe, const float* lns,
                               const float* lnb, const void* w,
                               const float* qnorm, const void* abig,
                               const void* kpt, const void* vp,
                               const float* gamma, void* out, int B, int N,
                               int C, int P, int heads, float eps,
                               void* stream) {
  const int T = tile_tokens(C);
  const size_t smem = ((size_t)5 * T * C + (size_t)T * P) * sizeof(float);
  cudaFuncSetAttribute(dsa_phase_b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((N + T - 1) / T, B);
  dsa_phase_b<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), pe, lns, lnb,
      static_cast<const __nv_bfloat16*>(w), qnorm,
      static_cast<const __nv_bfloat16*>(abig),
      static_cast<const __nv_bfloat16*>(kpt),
      static_cast<const __nv_bfloat16*>(vp), gamma,
      static_cast<__nv_bfloat16*>(out), N, C, P, heads, T, eps);
  return static_cast<int>(cudaGetLastError());
}
