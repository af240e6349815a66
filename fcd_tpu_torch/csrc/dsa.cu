// B5: the fused eval dual self-attention (DSA, sa_type 'parallel') on the
// tensor cores (Hopper, sm_90a): phase A, its finishing pass, phase B.
//
// Replaces fcd_tpu/kernels/dsa_attention.py::dsa_fused: its phase A
// pallas_call (:243), the XLA glue between the phases (:277-300) and its
// phase B pallas_call (:310). The function is dsa_fused's, 'parallel'
// layout, with the fused pos-embed, LayerNorm and residual:
//   t = x + pe (f32),  xln = bf16(LN(t) * ln_scale + ln_bias)
//   q, k, v_ca, v_sa = xln @ w[:, slot * C ...]   (slots 0..3 of the flax
//                      (C, 4C) qkvv matrix; bf16 operands, f32 sums)
// Head h owns the channels [h*ch, (h+1)*ch), ch = C / heads, and all of
// the function is per head:
//   phase A (sums over the tokens): qk_h = q_h^T k_h (ch x ch, f32 q, k),
//     q2 = sum q^2, k2 = sum k^2, kp = bf16(k)^T ef, vp = bf16(v_sa)^T ef
//   finishing pass: qnorm = rsqrt(q2 + 1e-12), knorm likewise,
//     A_h = softmax_row(qk_h * qnorm * knorm * t1_h), abig_h = bf16(A_h^T),
//     kpt = bf16(kp * t2_h), vp = bf16(vp)
//   phase B (per token): qn = bf16(q * qnorm), out_ca = bf16(v_ca) abig_h,
//     s = softmax_p(qn kpt_h), out_sa = bf16(s) vp_h^T,
//     y = bf16(t + gamma * (out_ca + out_sa))
// The rounding points are dsa_fused's; q and k enter q^T k, q2 and k2 in
// f32, as the TPU kernel's f32 projections do.
//
// What bounds it (H100: 989 TFLOP/s bf16, 3.35 TB/s): per token each phase
// reads ~6C bytes (bf16 x, f32 pos-embed) and does ~6C^2 + 4CP operations,
// 30-250 operations a byte, under the card's ~295: the bytes. But the
// levels are small (N = 64 .. 32768 tokens, C = 8 .. 512), so the bound
// is 0.2-3 us and what costs is latency: too few blocks for 132 SMs, long
// chains of dependent steps in a block, and launches. The design:
//   * The grid is (token chunk or tile, head, batch): a block computes only
//     its head's ch columns of the projections, from the full LayerNormed
//     token row (the LN is repeated per head, cheap), so phase A computes
//     only the h diagonal ch x ch blocks of q^T k that the glue reads, and
//     even the 64-token level launches 16 blocks of each phase.
//   * Products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     accumulators) fed by ldmatrix, for the projections (tokens x C x ch,
//     the head's weight columns staged once per block, f32 rounded to bf16
//     on load), for kp | vp (ef^T [bf16(k) | bf16(v_sa)], the tokens as the
//     k-dimension), and in phase B for the channel attention, the scores
//     and s vp^T; the softmax over P runs on the accumulator fragments
//     (quad shuffles), and they become the next product's operand in
//     registers. ch <= 8 pads the k-dimension with zeros to 16.
//   * q^T k, q2 and k2 take q and k in f32 on the CUDA cores: ch^2 + 2ch
//     fused multiply-adds a token per head, each thread owning fixed
//     outputs (and, at ch = 8, a fixed slice of the tile's tokens).
//   * Phase A's blocks walk a chunk of token tiles, keep their sums in
//     registers, and write one partial record a chunk; the finishing pass
//     adds the records in chunk order (no atomics: two calls give the same
//     bits), 16 loads in flight a thread, kp | vp spread over blocks of
//     their own, and does the glue in the block that adds q^T k: a DSA
//     call is three launches with no PyTorch op between them.
//   * Tiles and chunks come from kernels/dsa_attention.py::dsa_plan (pure
//     Python): small levels get 16-token tiles and more blocks, level 3
//     128-token tiles walked four to a block. kernels/dsa_sweep.py --plans
//     times every tile and chunk length on the card (PERF.md).
//
// Widths: ch a power of two from 2 to 128, P 16, 32, 64 or 128, C = ch x
// heads a power of two from 8 to 512: every (C, P) that MS_DSA_NET reaches
// with 4 heads at feature sizes 4-32 and project sizes 16-128, all inside
// the JAX kernel's gate (dsa_fused_supported: C and P 8-512).
//   * ch 2 and 4 lie below mma.sync's n = 8: the head's columns are staged
//     padded with zero columns to CHP = 8, which add nothing to the
//     products; the per-head sums, the softmax and the stores read only the
//     ch real columns. C = 8 pads the projections' depth with zero rows
//     (weights) and columns (tokens) to 16.
//   * ch = 128: a head's q | k | v_sa weights are C x 3ch bf16 (393 KB at
//     C = 512), over the 227 KB a block may hold, and phase B's q | v_ca
//     262 KB. Those blocks stream the weights over C in chunks of KW rows
//     through a double buffer: the next chunk's loads are in flight while
//     the tensor cores take this one, held in registers (where f32 weights
//     are rounded to bf16, which cp.async cannot do) and stored into the
//     other buffer, one barrier a chunk. They take 16-token tiles: one
//     m-tile, each warp a fixed run of the projection's n-tiles, its sums
//     in registers across the chunks. Other widths stage their weights once
//     a block, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;            // threads of a phase A or B block
constexpr int NW = NT / 32;
constexpr int FT = 1024;           // threads of a finishing-pass block
constexpr int SMEM_CAP = 232448;   // shared memory one block may hold
constexpr int KW = 32;             // weight rows (of C) a streamed chunk
constexpr int STREAM_CH = 128;     // head widths that stream their weights
constexpr float L2_EPS = 1e-12f;   // fcd_tpu/ops/attention.py::_l2_normalize

// a bf16 row pitch of at least n elements: a multiple of 8 elements that
// is an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads sit in
// distinct banks (kernels/dsa_attention.py::_pitch)
__host__ __device__ constexpr int pitch(int n) {
  return (n + 7) / 8 * 8 + (((n + 7) / 8) % 2 == 0 ? 8 : 16);
}

// a head's columns as staged: ch, padded with zero columns to mma's n = 8
__host__ __device__ constexpr int padded(int ch) { return ch < 8 ? 8 : ch; }

// the projections' depth: C, padded with zeros to mma's k = 16
__host__ __device__ constexpr int depth(int c) { return c < 16 ? 16 : c; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight consecutive values of an f32 or bf16 array from element i
// (i % 8 == 0, the array 16-byte aligned), as bf16
__device__ __forceinline__ uint4 load8(const void* src, int f32, size_t i) {
  if (f32) {
    const float4* s =
        reinterpret_cast<const float4*>(static_cast<const float*>(src) + i);
    const float4 lo = s[0], hi = s[1];
    return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                      pack2(hi.z, hi.w));
  }
  return *reinterpret_cast<const uint4*>(static_cast<const bf16*>(src) + i);
}

// element i of an f32 or bf16 array, as bf16
__device__ __forceinline__ bf16 load1(const void* src, int f32, size_t i) {
  return f32 ? __float2bfloat16(static_cast<const float*>(src)[i])
             : static_cast<const bf16*>(src)[i];
}

// what both phases read
struct Tok {
  const bf16* x;     // (B, N, C) raw tokens
  const float* pe;   // (N, C) pos-embed, or null
  const float* lns;  // (C,) LayerNorm scale
  const float* lnb;  // (C,) LayerNorm bias
  const void* w;     // the flax qkvv matrix (C, 4C), f32 or bf16
  int w_f32;
  int N, C, heads, T;  // T tokens a tile
  float eps;
};

// columns h*CH .. h*CH + CH of NS slots of the qkvv matrix (slot j's index
// in the 4 bits j of `slots`), all C rows, as bf16 into Ws (pitch wp):
// slot j at column j*CHP, its columns CH .. CHP zero; rows C .. depth(C)
// zero
template <int CH, int NS>
__device__ void stage_weights(const Tok& tk, int slots, int h, bf16* Ws,
                              int wp) {
  constexpr int CHP = padded(CH);
  const int C = tk.C;
  if constexpr (CH >= 8) {
    constexpr int VR = NS * CH / 8;  // 8-column vectors a row
    constexpr int U = 8;             // vectors in flight a thread
    for (int v0 = threadIdx.x; v0 < C * VR; v0 += U * NT) {
      uint4 val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * NT;
        if (v >= C * VR) break;
        const int k = v / VR, r = v - k * VR;
        const int j = r / (CH / 8), n = (r - j * (CH / 8)) * 8;
        val[u] = load8(tk.w, tk.w_f32,
                       (size_t)k * 4 * C + ((slots >> (4 * j)) & 15) * C +
                           h * CH + n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * NT;
        if (v >= C * VR) break;
        const int k = v / VR, r = v - k * VR;
        *reinterpret_cast<uint4*>(Ws + k * wp + r * 8) = val[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < C * NS * CHP; i += NT) {
      const int k = i / (NS * CHP), r = i - k * (NS * CHP);
      const int j = r / CHP, n = r - j * CHP;
      Ws[k * wp + r] =
          n < CH ? load1(tk.w, tk.w_f32,
                         (size_t)k * 4 * C + ((slots >> (4 * j)) & 15) * C +
                             h * CH + n)
                 : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < (depth(C) - C) * NS * CHP; i += NT) {
    const int k = i / (NS * CHP);
    Ws[(C + k) * wp + i - k * (NS * CHP)] = __float2bfloat16(0.f);
  }
}

// rows k0 .. k0 + KW of the head's columns of NS slots (streamed widths,
// CH % 8 == 0), U 8-column vectors a thread, held in registers as bf16
// between their loads and their store into one buffer of a double buffer
template <int CH, int NS>
struct WeightChunk {
  static constexpr int VR = NS * CH / 8;  // vectors a row
  static constexpr int U = KW * VR / NT;  // vectors a thread
  static_assert(KW * VR % NT == 0, "a chunk splits evenly over the block");
  uint4 v[U];

  __device__ __forceinline__ void load(const Tok& tk, int slots, int h,
                                       int k0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT;
      const int k = i / VR, r = i - k * VR;
      const int j = r / (CH / 8), n = (r - j * (CH / 8)) * 8;
      v[u] = load8(tk.w, tk.w_f32,
                   (size_t)(k0 + k) * 4 * tk.C +
                       ((slots >> (4 * j)) & 15) * tk.C + h * CH + n);
    }
  }

  __device__ __forceinline__ void store(bf16* Wb, int wp) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT;
      const int k = i / VR;
      *reinterpret_cast<uint4*>(Wb + k * wp + (i - k * VR) * 8) = v[u];
    }
  }
};

// (pos-embed +) LayerNorm of tokens n0 .. n0 + T of batch b into Xs (bf16,
// pitch xp), rows past N zero, columns C .. depth(C) zero. G = min(C / 8,
// 32) lanes share a token, V = C / (8 G) runs of 8 channels each (16-byte
// loads). With Bs, also t = x + pe of the head's channels c0 .. c0 + CH
// into Bs (f32, pitch CH).
template <int CH>
__device__ void ln_tile(const Tok& tk, int b, int n0, bf16* Xs, int xp,
                        float* Bs, int c0) {
  const int C = tk.C, G = C / 8 < 32 ? C / 8 : 32;  // lanes a token
  const int V = C / 8 / G;                          // runs a lane (1 or 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / G, lg = lane - sub * G;
  const int per_pass = NW * (32 / G);
  for (int t0 = 0; t0 < tk.T; t0 += per_pass) {
    const int t = t0 + warp * (32 / G) + sub;
    const int n = n0 + t;
    const bool ok = t < tk.T && n < tk.N;
    float v[2][8];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = (lg + r * G) * 8;
      if (ok && r < V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            tk.x + ((size_t)b * tk.N + n) * C + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[r][i] = __bfloat162float(e[i]);
        if (tk.pe != nullptr) {
          const float4* pe =
              reinterpret_cast<const float4*>(tk.pe + (size_t)n * C + c);
          const float4 lo = pe[0], hi = pe[1];
          v[r][0] += lo.x; v[r][1] += lo.y; v[r][2] += lo.z; v[r][3] += lo.w;
          v[r][4] += hi.x; v[r][5] += hi.y; v[r][6] += hi.z; v[r][7] += hi.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s += v[r][i];
          q += v[r][i] * v[r][i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[r][i] = 0.f;
      }
    }
    for (int o = G / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (t >= tk.T) continue;
    float mu = 0.f, rstd = 0.f;
    if (ok) {
      mu = s / C;
      rstd = rsqrtf(fmaxf(q / C - mu * mu, 0.f) + tk.eps);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= V) break;
      const int c = (lg + r * G) * 8;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (ok) {
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = (v[r][i] - mu) * rstd * tk.lns[c + i] + tk.lnb[c + i];
        packed = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                            pack2(y[4], y[5]), pack2(y[6], y[7]));
      }
      *reinterpret_cast<uint4*>(Xs + t * xp + c) = packed;
      if (Bs != nullptr) {
        if constexpr (CH >= 8) {
          if (c >= c0 && c < c0 + CH) {
            float4* dst = reinterpret_cast<float4*>(Bs + t * CH + c - c0);
            dst[0] = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
            dst[1] = make_float4(v[r][4], v[r][5], v[r][6], v[r][7]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c + i >= c0 && c + i < c0 + CH) Bs[t * CH + c + i - c0] = v[r][i];
        }
      }
    }
    if (C < 16 && lg == 0)
      *reinterpret_cast<uint4*>(Xs + t * xp + 8) = make_uint4(0, 0, 0, 0);
  }
}

template <int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[NI][4]) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// one warp's D[16 x 8*NI] += Xs[m0 .. m0 + 16][kx .. kx + K) . Ws[0 ..
// K)[n0 .. n0 + 8*NI), f32 accumulators (K % 16 == 0)
template <int NI>
__device__ __forceinline__ void proj_mma(const bf16* Xs, int xp, int kx,
                                         const bf16* Ws, int wp, int K,
                                         int m0, int n0, float (&acc)[NI][4]) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(Xs + (m0 + (lane & 15)) * xp + kx + k0 +
                        (lane >> 4) * 8));
    const bf16* wrow = Ws + (k0 + (lane & 15)) * wp + n0;
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      if (j + 1 < NI) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(wrow + j * 8 + (lane >> 4) * 8));
        mma16816(acc[j], a, bb[0], bb[1]);
        mma16816(acc[j + 1], a, bb[2], bb[3]);
      } else {
        uint32_t bb[2];
        ldsm_x2_t(bb, smem_u32(wrow + j * 8));
        mma16816(acc[j], a, bb[0], bb[1]);
      }
    }
  }
}

// the 16-token tile's projections D[16 x NS*CH] (T = 16) with the weights
// streamed over C in chunks of KW rows through the double buffer Wb (2 x
// KW rows, pitch wp): the next chunk's loads are in flight while the
// tensor cores take this one. Warp w owns n-tiles w*NTW .. (w + 1)*NTW.
// Xs must be written before the call; it ends with the block synchronised
// and Wb free.
template <int CH, int NS>
__device__ void proj_streamed(const Tok& tk, int slots, int h,
                              const bf16* Xs, int xp, bf16* Wb, int wp,
                              float (&acc)[NS * CH / 8 / NW][4]) {
  constexpr int NTW = NS * CH / 8 / NW;
  static_assert(NS * CH / 8 % NW == 0, "n-tiles split evenly over warps");
  const int n0 = (threadIdx.x >> 5) * NTW * 8;
  const int chunks = tk.C / KW;
  zero_acc(acc);
  WeightChunk<CH, NS> wc;
  wc.load(tk, slots, h, 0);
  wc.store(Wb, wp);
  __syncthreads();
  for (int i = 0; i < chunks; ++i) {
    if (i + 1 < chunks) wc.load(tk, slots, h, (i + 1) * KW);
    proj_mma<NTW>(Xs, xp, i * KW, Wb + (i & 1) * KW * wp, wp, KW, 0, n0,
                  acc);
    if (i + 1 < chunks) wc.store(Wb + ((i + 1) & 1) * KW * wp, wp);
    __syncthreads();
  }
}

// ---- phase A ---------------------------------------------------------------

struct ParamsA {
  Tok tk;
  const void* ef;  // (N, P) f32 or bf16
  int ef_f32;
  float* part;     // (chunks, B, heads, F) partial records
  int tiles, per_chunk;
};

template <int CH, int P>
struct ShapeA {
  static constexpr int CHP = padded(CH);
  static constexpr bool STREAM = CH >= STREAM_CH;
  static constexpr int WP = pitch(3 * CHP);  // weights q | k | v_sa
  static constexpr int EP = pitch(P);        // ef tile
  static constexpr int KP = pitch(2 * CHP);  // bf16(k) | bf16(v_sa)
  static constexpr int QP = 2 * CHP + 2;     // f32 q | k
  static constexpr int NO = CH * CH + 2 * CH;  // qk, q2, k2: CUDA-core sums
  static constexpr int S = NT / NO > 1 ? NT / NO : 1;  // token slices
  static constexpr int OPT = (NO * S + NT - 1) / NT;   // sums a thread
  static constexpr int F = NO + 2 * CH * P;  // floats of a partial record
  static constexpr int WMA = P / 16;         // kp | vp: warps along P
  static constexpr int WNA = NW / WMA;       //          and along 2 CHP
  static constexpr int NJ2 = 2 * CHP / 8;
  static constexpr int NIA = (NJ2 + WNA - 1) / WNA;
  static constexpr int NI = CHP / 8 < 4 ? CHP / 8 : 4;  // n-tiles a unit
  static constexpr int GROUPS = CHP / 8 / NI;
  static constexpr int NTW = 3 * CHP / 8 / NW;  // streamed: n-tiles a warp
  static int smem(int C, int T) {
    return 2 * ((STREAM ? 2 * KW : depth(C)) * WP + T * pitch(depth(C)) +
                T * EP + T * KP) +
           4 * (T * QP + (S > 1 ? S * NO : 0));
  }
};

// a projection's outputs (token rr, columns col, col + 1 of slot `slot`):
// q and k in f32 into QK, bf16(k) and bf16(v_sa) into KVs
template <int CHP>
__device__ __forceinline__ void put_a(float* QK, int qp, bf16* KVs, int kp,
                                      int slot, int rr, int col, float a0,
                                      float a1) {
  if (slot == 0) {
    *reinterpret_cast<float2*>(QK + rr * qp + col) = make_float2(a0, a1);
  } else if (slot == 1) {
    *reinterpret_cast<float2*>(QK + rr * qp + CHP + col) = make_float2(a0, a1);
    *reinterpret_cast<uint32_t*>(KVs + rr * kp + col) = pack2(a0, a1);
  } else {
    *reinterpret_cast<uint32_t*>(KVs + rr * kp + CHP + col) = pack2(a0, a1);
  }
}

// grid (chunk, head, batch): the chunk's token tiles, head h's columns
template <int CH, int P>
__global__ void __launch_bounds__(NT) dsa_phase_a_kernel(const ParamsA p) {
  using SA = ShapeA<CH, P>;
  constexpr int CHP = SA::CHP;
  const Tok& tk = p.tk;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = tk.C, T = tk.T, CK = depth(C), xp = pitch(CK);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // CK x WP staged weights, or the 2 x KW x WP double buffer
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* Xs = Ws + (SA::STREAM ? 2 * KW : CK) * SA::WP;  // T x xp
  bf16* Es = Xs + T * xp;                        // T x EP
  bf16* KVs = Es + T * SA::EP;                   // T x KP
  float* QK = reinterpret_cast<float*>(KVs + T * SA::KP);  // T x QP
  float* red = QK + T * SA::QP;                  // S x NO

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (!SA::STREAM)
    stage_weights<CH, 3>(tk, 0x310, h, Ws, SA::WP);  // slots q, k, v_sa

  // the CUDA-core sums this thread owns: u = tid + i*NT (u < NO * S) is
  // output u % NO (qk[r][c] = q_r . k_c, then q2, then k2) over token
  // slice u / NO
  float sacc[SA::OPT];
#pragma unroll
  for (int i = 0; i < SA::OPT; ++i) sacc[i] = 0.f;
  // kp | vp: D[P x 2CHP] = ef^T [bf16(k) | bf16(v_sa)]; warp (wm, wn) owns
  // rows wm*16 .. + 16 and n-tiles wn, wn + WNA, ...
  const int wm = warp % SA::WMA, wn = warp / SA::WMA;
  float kv[SA::NIA][4];
#pragma unroll
  for (int i = 0; i < SA::NIA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) kv[i][e] = 0.f;

  const int first = chunk * p.per_chunk;
  const int last = min(first + p.per_chunk, p.tiles);
  for (int tile = first; tile < last; ++tile) {
    const int n0 = tile * T;
    // the weights are staged; the last tile's sums are done with the tiles
    __syncthreads();
    ln_tile<CH>(tk, b, n0, Xs, xp, nullptr, 0);
    for (int v = tid; v < T * (P / 8); v += NT) {
      const int t = v / (P / 8), c = (v - t * (P / 8)) * 8;
      const int n = n0 + t;
      *reinterpret_cast<uint4*>(Es + t * SA::EP + c) =
          n < tk.N ? load8(p.ef, p.ef_f32, (size_t)n * P + c)
                   : make_uint4(0, 0, 0, 0);
    }
    if constexpr (SA::STREAM) {
      float acc[SA::NTW][4];
      proj_streamed<CH, 3>(tk, 0x310, h, Xs, xp, Ws, SA::WP, acc);
#pragma unroll
      for (int j = 0; j < SA::NTW; ++j) {
        const int gc = (warp * SA::NTW + j) * 8 + 2 * (lane & 3);
        const int slot = gc / CHP;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          put_a<CHP>(QK, SA::QP, KVs, SA::KP, slot, (lane >> 2) + 8 * hf,
                     gc - slot * CHP, acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    } else {
      __syncthreads();
      // projections, in units of (16-token m-tile, slot, group of NI
      // n-tiles)
      const int units = (T / 16) * 3 * SA::GROUPS;
      for (int u = warp; u < units; u += NW) {
        const int mt = u / (3 * SA::GROUPS), r = u - mt * 3 * SA::GROUPS;
        const int slot = r / SA::GROUPS, grp = r - slot * SA::GROUPS;
        float acc[SA::NI][4];
        zero_acc(acc);
        proj_mma<SA::NI>(Xs, xp, 0, Ws, SA::WP, CK, mt * 16,
                         slot * CHP + grp * SA::NI * 8, acc);
        const int row = mt * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < SA::NI; ++j) {
          const int col = grp * SA::NI * 8 + j * 8 + 2 * (lane & 3);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            put_a<CHP>(QK, SA::QP, KVs, SA::KP, slot, row + 8 * hf, col,
                       acc[j][2 * hf], acc[j][2 * hf + 1]);
        }
      }
    }
    __syncthreads();

    // q^T k, q2, k2 on the CUDA cores, f32 (rows past N are zero): columns
    // ca (of q, or of k for k2) and cb of QK; k's columns start at CHP
#pragma unroll
    for (int i = 0; i < SA::OPT; ++i) {
      const int u = tid + i * NT;
      if (u >= SA::NO * SA::S) continue;
      const int sl = u / SA::NO, o = u - sl * SA::NO;
      int ca, cb;
      if (o < CH * CH) {
        ca = o / CH;
        cb = CHP + o % CH;
      } else if (o < CH * CH + CH) {
        ca = cb = o - CH * CH;
      } else {
        ca = cb = CHP + o - CH * CH - CH;
      }
      const int t1 = (sl + 1) * T / SA::S;
      float s = sacc[i];
      for (int t = sl * T / SA::S; t < t1; ++t)
        s = fmaf(QK[t * SA::QP + ca], QK[t * SA::QP + cb], s);
      sacc[i] = s;
    }
    // kp | vp on the tensor cores, the tile's tokens as the k-dimension
    for (int k0 = 0; k0 < T; k0 += 16) {
      uint32_t a[4];
      ldsm_x4_t(a, smem_u32(Es + (k0 + (lane >> 4) * 8 + (lane & 7)) * SA::EP +
                            wm * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int i = 0; i < SA::NIA; ++i) {
        const int j = wn + i * SA::WNA;
        if (j < SA::NJ2) {
          uint32_t bb[2];
          ldsm_x2_t(bb, smem_u32(KVs + (k0 + (lane & 15)) * SA::KP + j * 8));
          mma16816(kv[i], a, bb[0], bb[1]);
        }
      }
    }
  }

  // the chunk's partial record: [qk | q2 | k2 | kp (CH x P) | vp (CH x P)]
  float* rec = p.part + (((size_t)chunk * gridDim.z + b) * gridDim.y + h) *
                            SA::F;
  float* kvrec = rec + SA::NO;
#pragma unroll
  for (int i = 0; i < SA::NIA; ++i) {
    const int j = wn + i * SA::WNA;
    if (j >= SA::NJ2) continue;
    // column n of [k | v_sa] (CHP each): kp or vp row r; n and r are even
    // and CH is, so r + 1 < CH with r
    const int n = j * 8 + 2 * (lane & 3), pr = wm * 16 + (lane >> 2);
    const int half = n / CHP, r = n - half * CHP;
    if (r >= CH) continue;
    float* dst = kvrec + (half * CH + r) * P + pr;
    dst[0] = kv[i][0];
    dst[P] = kv[i][1];
    dst[8] = kv[i][2];
    dst[P + 8] = kv[i][3];
  }
  if (SA::S == 1) {
#pragma unroll
    for (int i = 0; i < SA::OPT; ++i)
      if (tid + i * NT < SA::NO) rec[tid + i * NT] = sacc[i];
  } else {
    // the token slices added in order
#pragma unroll
    for (int i = 0; i < SA::OPT; ++i)
      if (tid + i * NT < SA::NO * SA::S) red[tid + i * NT] = sacc[i];
    __syncthreads();
    for (int o = tid; o < SA::NO; o += NT) {
      float s = red[o];
      for (int sl = 1; sl < SA::S; ++sl) s += red[sl * SA::NO + o];
      rec[o] = s;
    }
  }
}

struct ParamsF {
  const float* part;
  int chunks, heads, C, CH, P;
  int glue;
  const float* t1;  // (heads,) temperature
  const float* t2;  // (heads,) temperature2
  // glue == 0, phase A's sums (f32): qk (B, heads, CH, CH), q2, k2 (B, C),
  // kp, vp (B, C, P)
  float *qk, *q2, *k2, *kp, *vp;
  // glue == 1, phase B's operands: qnorm (B, C) f32, abig (B, heads, CH,
  // CH), kpt, vpb (B, C, P) bf16
  float* qnorm;
  bf16 *abig, *kpt, *vpb;
};

// the records' value f added over the chunks, in chunk order; the loads
// go out 16 at a time, ahead of the adds (each is an L2 round trip)
__device__ __forceinline__ float chunk_sum(const float* src, size_t stride,
                                           int chunks) {
  constexpr int G = 16;
  float s = 0.f;
  int k = 0;
  for (; k + G <= chunks; k += G) {
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = __ldcg(src + (size_t)(k + j) * stride);
#pragma unroll
    for (int j = 0; j < G; ++j) s += v[j];
  }
  float v[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    v[j] = k + j < chunks ? __ldcg(src + (size_t)(k + j) * stride) : 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (k + j < chunks) s += v[j];
  return s;
}

constexpr int SOFTMAX_COLS = 4;  // columns a lane in the finishing pass's
                                 // softmax: CH <= 32 * 4

// grid (1 + kv blocks, head, batch), FT threads: each thread adds few
// values over the chunks, with many loads in flight. Block 0 adds qk, q2
// and k2 and (glue) does dsa_glue's steps with its rounding points; the
// others add FT values each of kp | vp and write them (glue: kpt =
// bf16(kp * t2), vp).
__global__ void __launch_bounds__(FT) dsa_phase_a_finish(const ParamsF p) {
  const int h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int CH = p.CH, P = p.P, C = p.C;
  const int NO = CH * CH + 2 * CH, F = NO + 2 * CH * P;
  const size_t stride = (size_t)B * p.heads * F;  // one chunk's records
  const float* src = p.part + ((size_t)b * p.heads + h) * F;
  const size_t row = (size_t)b * C + h * CH;  // the head's first channel
  if (blockIdx.x > 0) {
    const int g = (blockIdx.x - 1) * FT + threadIdx.x;
    if (g >= 2 * CH * P) return;
    const float s = chunk_sum(src + NO + g, stride, p.chunks);
    const bool is_vp = g >= CH * P;
    const size_t i = row * P + (is_vp ? g - CH * P : g);
    if (!p.glue)
      (is_vp ? p.vp : p.kp)[i] = s;
    else
      (is_vp ? p.vpb : p.kpt)[i] = __float2bfloat16(is_vp ? s : s * p.t2[h]);
    return;
  }
  extern __shared__ float sm[];  // NO sums, then qnorm and knorm (2 CH)
  for (int f = threadIdx.x; f < NO; f += FT) {
    const float s = chunk_sum(src + f, stride, p.chunks);
    sm[f] = s;
    if (!p.glue) {
      if (f < CH * CH)
        p.qk[((size_t)b * p.heads + h) * CH * CH + f] = s;
      else if (f < CH * CH + CH)
        p.q2[row + f - CH * CH] = s;
      else
        p.k2[row + f - CH * CH - CH] = s;
    }
  }
  if (!p.glue) return;
  __syncthreads();
  float* qn = sm + NO;
  float* kn = qn + CH;
  for (int c = threadIdx.x; c < CH; c += FT) {
    qn[c] = rsqrtf(sm[CH * CH + c] + L2_EPS);
    kn[c] = rsqrtf(sm[CH * CH + CH + c] + L2_EPS);
    p.qnorm[row + c] = qn[c];
  }
  __syncthreads();
  // A = softmax_row(qk * qnorm_r * knorm_c * t1), stored transposed; lane
  // l takes columns l, l + 32, ...
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float t1 = p.t1[h];
  bf16* ab = p.abig + ((size_t)b * p.heads + h) * CH * CH;
  for (int r = warp; r < CH; r += FT / 32) {
    float v[SOFTMAX_COLS], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SOFTMAX_COLS; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < CH ? sm[r * CH + c] * qn[r] * kn[c] * t1 : -INFINITY;
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SOFTMAX_COLS; ++i) {
      v[i] = lane + 32 * i < CH ? expf(v[i] - mx) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < SOFTMAX_COLS; ++i) {
      const int c = lane + 32 * i;
      if (c < CH) ab[c * CH + r] = __float2bfloat16(v[i] / sum);
    }
  }
}

// ---- phase B ---------------------------------------------------------------

struct ParamsB {
  Tok tk;
  const float* qnorm;  // (B, C)
  const bf16* abig;    // (B, heads, CH, CH): out_ca[n, c] = sum_d v[n, d] abig[d, c]
  const bf16* kpt;     // (B, C, P)
  const bf16* vp;      // (B, C, P)
  const float* gamma;  // (C,)
  bf16* out;           // (B, N, C)
};

template <int CH, int P>
struct ShapeB {
  static constexpr int CHP = padded(CH);
  static constexpr bool STREAM = CH >= STREAM_CH;
  static constexpr int KC = CHP < 16 ? 16 : CHP;  // ch-deep products' depth
  static constexpr int WP = pitch(2 * CHP);       // weights q | v_ca
  static constexpr int QP = pitch(KC);            // qn, v_ca, the output
  static constexpr int AP = pitch(CHP);           // abig_h
  static constexpr int PP = pitch(P);             // kpt_h, vp_h
  static constexpr int NI = CHP / 8 < 4 ? CHP / 8 : 4;
  static constexpr int GROUPS = CHP / 8 / NI;
  static constexpr int NTW = 2 * CHP / 8 / NW;    // streamed: n-tiles a warp
  static int smem(int C, int T) {
    return 2 * ((STREAM ? 2 * KW : depth(C)) * WP + T * pitch(depth(C)) +
                2 * T * QP + KC * AP + KC * PP + CHP * PP) +
           4 * (T * CH + 2 * CHP);
  }
};

// a projection's outputs (token rr, columns col, col + 1 of slot `slot`):
// bf16(q * qnorm) into Qs, bf16(v_ca) into Vs
__device__ __forceinline__ void put_b(bf16* Qs, bf16* Vs, int qp,
                                      const float* qn_s, int slot, int rr,
                                      int col, float a0, float a1) {
  if (slot == 0) {
    a0 *= qn_s[col];
    a1 *= qn_s[col + 1];
  }
  *reinterpret_cast<uint32_t*>((slot == 0 ? Qs : Vs) + rr * qp + col) =
      pack2(a0, a1);
}

// grid (token tile, head, batch)
template <int CH, int P>
__global__ void __launch_bounds__(NT) dsa_phase_b_kernel(const ParamsB p) {
  using SB = ShapeB<CH, P>;
  constexpr int KC = SB::KC, CHP = SB::CHP;
  const Tok& tk = p.tk;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = tk.C, T = tk.T, CK = depth(C), xp = pitch(CK);
  const int n0 = blockIdx.x * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // CK x WP staged weights, or the 2 x KW x WP double buffer
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* Xs = Ws + (SB::STREAM ? 2 * KW : CK) * SB::WP;  // T x xp
  bf16* Qs = Xs + T * xp;                        // T x QP: qn, then y
  bf16* Vs = Qs + T * SB::QP;                    // T x QP: bf16(v_ca)
  bf16* ABs = Vs + T * SB::QP;                   // KC x AP
  bf16* KPs = ABs + KC * SB::AP;                 // KC x PP
  bf16* VPs = KPs + KC * SB::PP;                 // CHP x PP
  float* Bs = reinterpret_cast<float*>(VPs + CHP * SB::PP);  // T x CH
  float* qn_s = Bs + T * CH;                     // CHP
  float* gm_s = qn_s + CHP;                      // CHP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (!SB::STREAM)
    stage_weights<CH, 2>(tk, 0x20, h, Ws, SB::WP);  // slots q, v_ca
  ln_tile<CH>(tk, b, n0, Xs, xp, Bs, h * CH);
  const size_t hc = (size_t)b * C + h * CH;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const bf16* abh = p.abig + ((size_t)b * tk.heads + h) * CH * CH;
  if constexpr (CH >= 8) {
    for (int v = tid; v < KC * (CH / 8); v += NT) {
      const int r = v / (CH / 8), c = (v - r * (CH / 8)) * 8;
      *reinterpret_cast<uint4*>(ABs + r * SB::AP + c) =
          r < CH ? *reinterpret_cast<const uint4*>(abh + r * CH + c) : zero;
    }
  } else {
    for (int v = tid; v < KC * CHP; v += NT) {
      const int r = v / CHP, c = v - r * CHP;
      ABs[r * SB::AP + c] =
          r < CH && c < CH ? abh[r * CH + c] : __float2bfloat16(0.f);
    }
  }
  for (int v = tid; v < KC * (P / 8); v += NT) {
    const int r = v / (P / 8), c = (v - r * (P / 8)) * 8;
    *reinterpret_cast<uint4*>(KPs + r * SB::PP + c) =
        r < CH ? *reinterpret_cast<const uint4*>(p.kpt + (hc + r) * P + c)
               : zero;
    if (r < CHP)
      *reinterpret_cast<uint4*>(VPs + r * SB::PP + c) =
          r < CH ? *reinterpret_cast<const uint4*>(p.vp + (hc + r) * P + c)
                 : zero;
  }
  for (int c = tid; c < CHP; c += NT) {
    qn_s[c] = c < CH ? p.qnorm[hc + c] : 0.f;
    gm_s[c] = c < CH ? p.gamma[h * CH + c] : 0.f;
  }
  if (KC > CHP)  // zero depth padding of qn and v_ca (CHP = 8)
    for (int v = tid; v < 2 * T; v += NT)
      *reinterpret_cast<uint4*>((v < T ? Qs : Vs) + (v % T) * SB::QP + CHP) =
          zero;
  __syncthreads();

  // q and v_ca of the head
  if constexpr (SB::STREAM) {
    float acc[SB::NTW][4];
    proj_streamed<CH, 2>(tk, 0x20, h, Xs, xp, Ws, SB::WP, acc);
#pragma unroll
    for (int j = 0; j < SB::NTW; ++j) {
      const int gc = (warp * SB::NTW + j) * 8 + 2 * (lane & 3);
      const int slot = gc / CHP;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        put_b(Qs, Vs, SB::QP, qn_s, slot, (lane >> 2) + 8 * hf,
              gc - slot * CHP, acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  } else {
    // in units of (m-tile, slot, group)
    const int units = (T / 16) * 2 * SB::GROUPS;
    for (int u = warp; u < units; u += NW) {
      const int mt = u / (2 * SB::GROUPS), r = u - mt * 2 * SB::GROUPS;
      const int slot = r / SB::GROUPS, grp = r - slot * SB::GROUPS;
      float acc[SB::NI][4];
      zero_acc(acc);
      proj_mma<SB::NI>(Xs, xp, 0, Ws, SB::WP, CK, mt * 16,
                       slot * CHP + grp * SB::NI * 8, acc);
      const int row = mt * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < SB::NI; ++j) {
        const int col = grp * SB::NI * 8 + j * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          put_b(Qs, Vs, SB::QP, qn_s, slot, row + 8 * hf, col,
                acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    }
  }
  __syncthreads();

  // both attentions, one warp a 16-token m-tile
  for (int mt = warp; mt < T / 16; mt += NW) {
    const int m0 = mt * 16;
    if (n0 + m0 >= tk.N) continue;
    const int aoff = (m0 + (lane & 15)) * SB::QP + (lane >> 4) * 8;
    float o[CHP / 8][4];
    zero_acc(o);
    // channel attention: o = bf16(v_ca) . abig_h
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t av[4];
      ldsm_x4(av, smem_u32(Vs + aoff + kk * 16));
      const bf16* brow = ABs + (kk * 16 + (lane & 15)) * SB::AP;
#pragma unroll
      for (int j = 0; j < CHP / 8; j += 2) {
        if (j + 1 < CHP / 8) {
          uint32_t bb[4];
          ldsm_x4_t(bb, smem_u32(brow + j * 8 + (lane >> 4) * 8));
          mma16816(o[j], av, bb[0], bb[1]);
          mma16816(o[j + 1], av, bb[2], bb[3]);
        } else {
          uint32_t bb[2];
          ldsm_x2_t(bb, smem_u32(brow + j * 8));
          mma16816(o[j], av, bb[0], bb[1]);
        }
      }
    }
    // scores s = qn . kpt_h (16 x P, f32)
    float s[P / 8][4];
    zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t aq[4];
      ldsm_x4(aq, smem_u32(Qs + aoff + kk * 16));
      const bf16* brow = KPs + (kk * 16 + (lane & 15)) * SB::PP;
#pragma unroll
      for (int j = 0; j < P / 8; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(brow + j * 8 + (lane >> 4) * 8));
        mma16816(s[j], aq, bb[0], bb[1]);
        mma16816(s[j + 1], aq, bb[2], bb[3]);
      }
    }
    // softmax over P: rows g (s[.][0..1]) and g + 8 (s[.][2..3]), each
    // spread over the four lanes of a quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    // o += bf16(softmax) . vp_h^T: the probabilities are the A operand in
    // registers (n-tiles 2kk, 2kk + 1 of s are k-step kk)
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      const uint32_t a[4] = {
          pack2(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0),
          pack2(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1),
          pack2(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0),
          pack2(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1)};
#pragma unroll
      for (int j = 0; j < CHP / 8; j += 2) {
        if (j + 1 < CHP / 8) {
          uint32_t bb[4];
          ldsm_x4(bb, smem_u32(VPs + (j * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                         SB::PP +
                               kk * 16 + ((lane >> 3) & 1) * 8));
          mma16816(o[j], a, bb[0], bb[1]);
          mma16816(o[j + 1], a, bb[2], bb[3]);
        } else {
          uint32_t bb[2];
          ldsm_x2(bb, smem_u32(VPs + (j * 8 + (lane & 7)) * SB::PP + kk * 16 +
                               ((lane >> 3) & 1) * 8));
          mma16816(o[j], a, bb[0], bb[1]);
        }
      }
    }
    // y = bf16(t + gamma * o) of the head's CH real channels, staged in
    // this warp's rows of Qs, then stored as 16-byte runs (CH >= 8) or
    // element by element
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CHP / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col >= CH) continue;
      const int r = m0 + (lane >> 2);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = r + 8 * hf;
        *reinterpret_cast<uint32_t*>(Qs + rr * SB::QP + col) =
            pack2(Bs[rr * CH + col] + gm_s[col] * o[j][2 * hf],
                  Bs[rr * CH + col + 1] + gm_s[col + 1] * o[j][2 * hf + 1]);
      }
    }
    __syncwarp();
    bf16* dst = p.out + ((size_t)b * tk.N + n0 + m0) * C + h * CH;
    if constexpr (CH >= 8) {
      for (int v = lane; v < 16 * (CH / 8); v += 32) {
        const int r = v / (CH / 8), c = (v - r * (CH / 8)) * 8;
        if (n0 + m0 + r < tk.N)
          *reinterpret_cast<uint4*>(dst + (size_t)r * C + c) =
              *reinterpret_cast<const uint4*>(Qs + (m0 + r) * SB::QP + c);
      }
    } else {
      for (int v = lane; v < 16 * CH; v += 32) {
        const int r = v / CH, c = v - r * CH;
        if (n0 + m0 + r < tk.N)
          dst[(size_t)r * C + c] = Qs[(m0 + r) * SB::QP + c];
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

// the shared-memory cap of one kernel instance, set on its first launch
template <typename K>
cudaError_t allow_smem(K kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  done = e == cudaSuccess;
  return e;
}

template <int CH, int P>
int launch_a(const ParamsA& pa, const ParamsF& pf, int chunks, int B,
             cudaStream_t s) {
  using SA = ShapeA<CH, P>;
  static bool ready = false, finish_ready = false;
  auto kern = dsa_phase_a_kernel<CH, P>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the finishing pass holds NO + 2 CH floats (67.6 KB at CH = 128)
  e = allow_smem(dsa_phase_a_finish, finish_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = SA::smem(pa.tk.C, pa.tk.T);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(chunks, pa.tk.heads, B), NT, bytes, s>>>(pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kv_blocks = (2 * CH * P + FT - 1) / FT;
  dsa_phase_a_finish<<<dim3(1 + kv_blocks, pa.tk.heads, B), FT,
                       (SA::NO + 2 * CH) * sizeof(float), s>>>(pf);
  return static_cast<int>(cudaGetLastError());
}

template <int CH, int P>
int launch_b(const ParamsB& pb, int B, cudaStream_t s) {
  static bool ready = false;
  auto kern = dsa_phase_b_kernel<CH, P>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = ShapeB<CH, P>::smem(pb.tk.C, pb.tk.T);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (pb.tk.N + pb.tk.T - 1) / pb.tk.T;
  kern<<<dim3(tiles, pb.tk.heads, B), NT, bytes, s>>>(pb);
  return static_cast<int>(cudaGetLastError());
}

Tok tokens(const void* x, const float* pe, const float* lns, const float* lnb,
           const void* w, int w_f32, int N, int C, int heads, int T,
           float eps) {
  Tok t;
  t.x = static_cast<const bf16*>(x);
  t.pe = pe;
  t.lns = lns;
  t.lnb = lnb;
  t.w = w;
  t.w_f32 = w_f32;
  t.N = N;
  t.C = C;
  t.heads = heads;
  t.T = T;
  t.eps = eps;
  return t;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// the shapes the kernels take (kernels/dsa_attention.py::plan_for checks
// them first): ch a power of two from 2 to 128, P in {16, 32, 64, 128}, C
// a power of two from 8 to 512, T a multiple of 16, and T = 16 where the
// weights stream (ch = 128)
bool supported(int C, int P, int heads, int T) {
  if (heads <= 0 || C % heads) return false;
  const int ch = C / heads;
  return pow2(ch) && ch >= 2 && ch <= 128 &&
         (P == 16 || P == 32 || P == 64 || P == 128) && C >= 8 && C <= 512 &&
         C % 8 == 0 && pow2(C / 8) && T > 0 && T % 16 == 0 &&
         (ch < STREAM_CH || (T == 16 && C % KW == 0));
}

// the instances: every (ch, P) of supported(), keyed ch * 1000 + P
#define DSA_CASES_CH(CH, CALL)                \
  case CH * 1000 + 16: return CALL(CH, 16);   \
  case CH * 1000 + 32: return CALL(CH, 32);   \
  case CH * 1000 + 64: return CALL(CH, 64);   \
  case CH * 1000 + 128: return CALL(CH, 128);
#define DSA_CASES(CALL)                                                  \
  DSA_CASES_CH(2, CALL) DSA_CASES_CH(4, CALL) DSA_CASES_CH(8, CALL)      \
  DSA_CASES_CH(16, CALL) DSA_CASES_CH(32, CALL) DSA_CASES_CH(64, CALL)   \
  DSA_CASES_CH(128, CALL)

}  // namespace

// phase A and its finishing pass. part: (chunks, B, heads, F) f32 scratch;
// glue 0: o0..o4 = qk, q2, k2, kp, vp (f32); glue 1: o0..o3 = qnorm (f32),
// abig, kpt, vp (bf16), t1/t2 the (heads,) temperatures
extern "C" int fcd_dsa_phase_a(const void* x, const float* pe,
                               const float* lns, const float* lnb,
                               const void* w, int w_f32, const void* ef,
                               int ef_f32, float* part, int glue,
                               const float* t1, const float* t2, void* o0,
                               void* o1, void* o2, void* o3, void* o4, int B,
                               int N, int C, int P, int heads, int T,
                               int per_chunk, int chunks, float eps,
                               void* stream) {
  if (!supported(C, P, heads, T) || per_chunk < 1 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ParamsA pa;
  pa.tk = tokens(x, pe, lns, lnb, w, w_f32, N, C, heads, T, eps);
  pa.ef = ef;
  pa.ef_f32 = ef_f32;
  pa.part = part;
  pa.tiles = (N + T - 1) / T;
  pa.per_chunk = per_chunk;
  ParamsF pf;
  pf.part = part;
  pf.chunks = chunks;
  pf.heads = heads;
  pf.C = C;
  pf.CH = C / heads;
  pf.P = P;
  pf.glue = glue;
  pf.t1 = t1;
  pf.t2 = t2;
  pf.qk = pf.q2 = pf.k2 = pf.kp = pf.vp = pf.qnorm = nullptr;
  pf.abig = pf.kpt = pf.vpb = nullptr;
  if (glue) {
    pf.qnorm = static_cast<float*>(o0);
    pf.abig = static_cast<bf16*>(o1);
    pf.kpt = static_cast<bf16*>(o2);
    pf.vpb = static_cast<bf16*>(o3);
  } else {
    pf.qk = static_cast<float*>(o0);
    pf.q2 = static_cast<float*>(o1);
    pf.k2 = static_cast<float*>(o2);
    pf.kp = static_cast<float*>(o3);
    pf.vp = static_cast<float*>(o4);
  }
#define DSA_LAUNCH_A(CH, P_) launch_a<CH, P_>(pa, pf, chunks, B, s)
  switch ((C / heads) * 1000 + P) {
    DSA_CASES(DSA_LAUNCH_A)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DSA_LAUNCH_A
}

extern "C" int fcd_dsa_phase_b(const void* x, const float* pe,
                               const float* lns, const float* lnb,
                               const void* w, int w_f32, const float* qnorm,
                               const void* abig, const void* kpt,
                               const void* vp, const float* gamma, void* out,
                               int B, int N, int C, int P, int heads, int T,
                               float eps, void* stream) {
  if (!supported(C, P, heads, T))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ParamsB pb;
  pb.tk = tokens(x, pe, lns, lnb, w, w_f32, N, C, heads, T, eps);
  pb.qnorm = qnorm;
  pb.abig = static_cast<const bf16*>(abig);
  pb.kpt = static_cast<const bf16*>(kpt);
  pb.vp = static_cast<const bf16*>(vp);
  pb.gamma = gamma;
  pb.out = static_cast<bf16*>(out);
#define DSA_LAUNCH_B(CH, P_) launch_b<CH, P_>(pb, B, s)
  switch ((C / heads) * 1000 + P) {
    DSA_CASES(DSA_LAUNCH_B)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DSA_LAUNCH_B
}
