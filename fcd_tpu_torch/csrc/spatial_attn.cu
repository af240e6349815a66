// K3 / K4: the train spatial-attention tail of the DSA block, forward and
// backward (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas (K3)
// and spatial_attn_bwd_pallas (K4). With qn (B, N, C) the l2-normalised
// queries, kpb (B, C, hP) the block-expanded keys (temperature folded in)
// and vpb (B, hP, C) the block-expanded values, all bf16:
//
//   s[n, :]  = softmax over each head's P-wide segment of (qn[n] . kpb)   (f32)
//   a        = bf16(keep ? s / (1 - rate) : 0)
//   out[n]   = bf16(a[n] . vpb)                                          (K3)
//
// K4 recomputes s and the mask and gives, with g the cotangent of out:
//   dvpb  += a^T g,   da = keep ? (g . vpb^T) / (1 - rate) : 0,
//   ds     = bf16(s * (da - sum_segment(da * s))),
//   dqn    = bf16(ds . kpb^T),   dkpb += qn^T ds             (f32 sums)
//
// Dropout: keep iff fmix32(idx * 0x9E3779B1 ^ key) >= rate * 2^32, where
// idx = (b * N + n) * hP + column (mod 2^32) and key mixes the step's seed
// with the layer's salt. It is a counter-based hash, so K4 regenerates K3's
// mask exactly, and kernels/spatial_attn.py computes the same bits with
// int64 torch ops for the plain version.
//
// What bounds it: ~4 * N * C * hP operations per direction (6 for K4)
// against ~2 * N * C * 2 bytes: at hP = 128..256 that is 256..512
// operations per byte, about the card's balance point; at these sizes
// (level 3: N = 32768, C = 32) the whole tail is a few GFLOP. The design
// keeps the (T x hP) attention tile in shared memory (it never goes to
// device memory, as on the TPU), one block per T = 16 tokens, the products
// on the CUDA cores in f32. K4 runs a block over a run of tiles and stages
// kpb and vpb in shared memory once per block, rows padded by two values
// so that both its row-wise and its column-wise walks are free of bank
// conflicts (read from device memory, the column-wise walks touched a
// cache line per thread). Its cross-tile sums dkpb and dvpb accumulate
// over the block's tiles, in shared memory where they fit (level 3), else
// in the block's own slot in device memory (each element owned by one
// thread), and each block writes one partial of each, at its slot of a
// (blocks, B, ...) buffer; the wrapper adds the partials over the blocks
// in a fixed order (no atomics), so they are the same bits run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // K3 threads per block
constexpr int NT_BWD = 512;  // K4 threads per block
constexpr int T = 16;        // tokens per tile

struct Params {
  const __nv_bfloat16* qn;   // (B, N, C)
  const __nv_bfloat16* kpb;  // (B, C, HP)
  const __nv_bfloat16* vpb;  // (B, HP, C)
  const __nv_bfloat16* g;    // (B, N, C) cotangent (K4)
  __nv_bfloat16* out;        // (B, N, C): out (K3) or dqn (K4)
  float* dkpb;               // (blocks, B, C, HP) f32 partials (K4)
  float* dvpb;               // (blocks, B, HP, C) f32 partials (K4)
  int N, C, HP, P;
  uint32_t key, thresh;
  float inv_keep;
  int drop;
  int tiles_per_block;       // K4
  int acc_smem;              // K4: cross-tile sums in shared memory
};

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

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep_bit(const Params& p, int b, int n, int q) {
  const uint32_t idx = (uint32_t)(((long long)b * p.N + n) * p.HP + q);
  return fmix32((idx * 0x9E3779B1u) ^ p.key) >= p.thresh;
}

// Q[t][c] <- tensor[b, n0 + t, c] (0 past N)
__device__ void load_tile(const __nv_bfloat16* __restrict__ src, float* dst,
                          int b, int n0, const Params& p) {
  for (int i = threadIdx.x; i < T * p.C; i += blockDim.x) {
    const int t = i / p.C, c = i % p.C;
    const int n = n0 + t;
    dst[i] = n < p.N ? __bfloat162float(src[((size_t)b * p.N + n) * p.C + c]) : 0.f;
  }
}

// S[t][q] <- softmax_segment(Q[t] . kpb[:, q]); A[t][q] <- bf16 dropped
// attn. kb: this batch's kpb, row c at kb + c * kstride.
__device__ void attention_tile(const float* Q, float* S, float* A,
                               const __nv_bfloat16* kb, int kstride, int b,
                               int n0, const Params& p) {
  for (int i = threadIdx.x; i < T * p.HP; i += blockDim.x) {
    const int t = i / p.HP, q = i % p.HP;
    const float* qr = Q + t * p.C;
    float acc = 0.f;
    for (int c = 0; c < p.C; ++c)
      acc = fmaf(qr[c], __bfloat162float(kb[(size_t)c * kstride + q]), acc);
    S[i] = acc;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = blockDim.x / 32;
  const int h = p.HP / p.P;
  for (int seg = warp; seg < T * h; seg += nwarp) {
    const int t = seg / h, hh = seg % h;
    float* s = S + t * p.HP + hh * p.P;
    float m = -INFINITY;
    for (int j = lane; j < p.P; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < p.P; j += 32) sum += expf(s[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < p.P; j += 32) {
      const float e = expf(s[j] - m) / sum;
      s[j] = e;
      float a = e;
      if (p.drop) a = keep_bit(p, b, n0 + t, hh * p.P + j) ? e * p.inv_keep : 0.f;
      A[t * p.HP + hh * p.P + j] = round_bf16(a);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) spatial_attn_fwd(const Params p) {
  extern __shared__ float smem[];
  float* Q = smem;             // T * C
  float* S = Q + T * p.C;      // T * HP
  float* A = S + T * p.HP;     // T * HP
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * T;
  load_tile(p.qn, Q, b, n0, p);
  __syncthreads();
  attention_tile(Q, S, A, p.kpb + (size_t)b * p.C * p.HP, p.HP, b, n0, p);
  const __nv_bfloat16* vb = p.vpb + (size_t)b * p.HP * p.C;
  for (int i = threadIdx.x; i < T * p.C; i += NT) {
    const int t = i / p.C, c = i % p.C;
    const int n = n0 + t;
    if (n >= p.N) continue;
    const float* ar = A + t * p.HP;
    float acc = 0.f;
    for (int q = 0; q < p.HP; ++q)
      acc = fmaf(ar[q], __bfloat162float(vb[(size_t)q * p.C + c]), acc);
    p.out[((size_t)b * p.N + n) * p.C + c] = __float2bfloat16(acc);
  }
}

__global__ void __launch_bounds__(NT_BWD) spatial_attn_bwd(const Params p) {
  extern __shared__ float smem[];
  const int CHP = p.C * p.HP;
  const int KS = p.HP + 2, VS = p.C + 2;  // padded row strides of Ks, Vs
  float* Q = smem;             // T * C
  float* G = Q + T * p.C;      // T * C
  float* S = G + T * p.C;      // T * HP
  float* A = S + T * p.HP;     // T * HP
  float* Dd = A + T * p.HP;    // T * HP
  float* accK = Dd + T * p.HP;                      // C * HP   (acc_smem)
  float* accV = accK + (p.acc_smem ? CHP : 0);      // HP * C   (acc_smem)
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
      accV + (p.acc_smem ? CHP : 0));               // C x (HP + 2)
  __nv_bfloat16* Vs = Ks + (size_t)p.C * KS;        // HP x (C + 2)
  const int b = blockIdx.y;
  const int nt = blockDim.x;
  const __nv_bfloat16* kb = p.kpb + (size_t)b * CHP;
  const __nv_bfloat16* vb = p.vpb + (size_t)b * CHP;
  // this block's partials
  const size_t slot = ((size_t)blockIdx.x * gridDim.y + b) * CHP;
  float* gK = p.dkpb + slot;
  float* gV = p.dvpb + slot;
  for (int i = threadIdx.x; i < CHP; i += nt) {
    Ks[(i / p.HP) * KS + i % p.HP] = kb[i];
    Vs[(i / p.C) * VS + i % p.C] = vb[i];
    if (p.acc_smem) {
      accK[i] = 0.f;
      accV[i] = 0.f;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = nt / 32;
  const int h = p.HP / p.P;
  for (int k = 0; k < p.tiles_per_block; ++k) {
    const int n0 = (blockIdx.x * p.tiles_per_block + k) * T;
    if (n0 >= p.N) break;
    load_tile(p.qn, Q, b, n0, p);
    load_tile(p.g, G, b, n0, p);
    __syncthreads();
    attention_tile(Q, S, A, Ks, KS, b, n0, p);
    // dvpb[q, c] += sum_t a[t, q] g[t, c]
    for (int i = threadIdx.x; i < CHP; i += nt) {
      const int q = i / p.C, c = i % p.C;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) acc = fmaf(A[t * p.HP + q], G[t * p.C + c], acc);
      if (p.acc_smem)
        accV[i] += acc;
      else
        gV[i] = k == 0 ? acc : gV[i] + acc;
    }
    // da[t, q] = sum_c g[t, c] vpb[q, c], masked and scaled like a
    for (int i = threadIdx.x; i < T * p.HP; i += nt) {
      const int t = i / p.HP, q = i % p.HP;
      const float* gr = G + t * p.C;
      const __nv_bfloat16* vr = Vs + (size_t)q * VS;
      float acc = 0.f;
      for (int c = 0; c < p.C; ++c) acc = fmaf(gr[c], __bfloat162float(vr[c]), acc);
      if (p.drop) acc = keep_bit(p, b, n0 + t, q) ? acc * p.inv_keep : 0.f;
      Dd[i] = acc;
    }
    __syncthreads();
    // ds = bf16(s * (da - sum_segment(da * s)))
    for (int seg = warp; seg < T * h; seg += nwarp) {
      const int t = seg / h, hh = seg % h;
      const float* s = S + t * p.HP + hh * p.P;
      float* d = Dd + t * p.HP + hh * p.P;
      float dot = 0.f;
      for (int j = lane; j < p.P; j += 32) dot += d[j] * s[j];
      dot = warp_sum(dot);
      for (int j = lane; j < p.P; j += 32) d[j] = round_bf16(s[j] * (d[j] - dot));
    }
    __syncthreads();
    // dqn[t, c] = bf16(sum_q ds[t, q] kpb[c, q])
    for (int i = threadIdx.x; i < T * p.C; i += nt) {
      const int t = i / p.C, c = i % p.C;
      const int n = n0 + t;
      if (n >= p.N) continue;
      const float* dr = Dd + t * p.HP;
      const __nv_bfloat16* kr = Ks + (size_t)c * KS;
      float acc = 0.f;
      for (int q = 0; q < p.HP; ++q) acc = fmaf(dr[q], __bfloat162float(kr[q]), acc);
      p.out[((size_t)b * p.N + n) * p.C + c] = __float2bfloat16(acc);
    }
    // dkpb[c, q] += sum_t qn[t, c] ds[t, q]
    for (int i = threadIdx.x; i < CHP; i += nt) {
      const int c = i / p.HP, q = i % p.HP;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) acc = fmaf(Q[t * p.C + c], Dd[t * p.HP + q], acc);
      if (p.acc_smem)
        accK[i] += acc;
      else
        gK[i] = k == 0 ? acc : gK[i] + acc;
    }
    __syncthreads();
  }
  if (p.acc_smem) {
    for (int i = threadIdx.x; i < CHP; i += nt) {
      gK[i] = accK[i];
      gV[i] = accV[i];
    }
  }
}

constexpr size_t kMaxSmem = 227 * 1024;  // the most a block can use

Params make(const void* qn, const void* kpb, const void* vpb, int N, int C,
            int HP, int P, unsigned key, unsigned thresh, float inv_keep,
            int drop) {
  Params p{};
  p.qn = static_cast<const __nv_bfloat16*>(qn);
  p.kpb = static_cast<const __nv_bfloat16*>(kpb);
  p.vpb = static_cast<const __nv_bfloat16*>(vpb);
  p.N = N;
  p.C = C;
  p.HP = HP;
  p.P = P;
  p.key = key;
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  p.drop = drop;
  return p;
}

}  // namespace

extern "C" int fcd_spatial_attn_fwd(const void* qn, const void* kpb,
                                    const void* vpb, void* out, int B, int N,
                                    int C, int HP, int P, unsigned key,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* stream) {
  Params p = make(qn, kpb, vpb, N, C, HP, P, key, thresh, inv_keep, drop);
  p.out = static_cast<__nv_bfloat16*>(out);
  const size_t smem = sizeof(float) * (size_t)T * (C + 2 * HP);
  cudaFuncSetAttribute(spatial_attn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kMaxSmem);
  dim3 grid((N + T - 1) / T, B);
  spatial_attn_fwd<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K4's blocks along the tokens, each over `per` token tiles: ~2 blocks per
// SM over the batch in all. Each writes one partial of dkpb and dvpb per
// batch item; the wrapper sizes the partial buffers with it.
extern "C" int fcd_spatial_attn_bwd_blocks(int B, int N, int* per) {
  const int ntiles = (N + T - 1) / T;
  const int want = (264 + B - 1) / B;
  *per = (ntiles + want - 1) / want;
  return (ntiles + *per - 1) / *per;
}

extern "C" int fcd_spatial_attn_bwd(const void* qn, const void* kpb,
                                    const void* vpb, const void* g, void* dqn,
                                    float* dkpb, float* dvpb, int B, int N,
                                    int C, int HP, int P, unsigned key,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* stream) {
  Params p = make(qn, kpb, vpb, N, C, HP, P, key, thresh, inv_keep, drop);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<__nv_bfloat16*>(dqn);
  p.dkpb = dkpb;
  p.dvpb = dvpb;
  const size_t tile = sizeof(float) * (size_t)T * (2 * C + 3 * HP);
  const size_t staged = sizeof(__nv_bfloat16) *
                        ((size_t)C * (HP + 2) + (size_t)HP * (C + 2));
  const size_t accs = sizeof(float) * 2 * (size_t)C * HP;
  if (tile + staged > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  p.acc_smem = tile + staged + accs <= kMaxSmem;
  const int blocks = fcd_spatial_attn_bwd_blocks(B, N, &p.tiles_per_block);
  const size_t smem = tile + staged + (p.acc_smem ? accs : 0);
  cudaFuncSetAttribute(spatial_attn_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kMaxSmem);
  dim3 grid(blocks, B);
  spatial_attn_bwd<<<grid, NT_BWD, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
