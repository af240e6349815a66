// K3 / K4: the train spatial-attention tail of the DSA block, forward and
// backward, on the tensor cores (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas (K3,
// pallas_call :166) and spatial_attn_bwd_pallas (K4, pallas_call :190).
// With qn (B, N, C) the l2-normalised queries, kpb (B, C, hP) the
// block-expanded keys (temperature folded in) and vpb (B, hP, C) the
// block-expanded values, all h16 (bf16, or f16 in the library built with
// -DFCD_F16: csrc/h16.cuh), h heads of P columns (hP = h * P):
//
//   s[n, :]  = softmax over each head's P-wide segment of (qn[n] . kpb)   (f32)
//   a        = h16(keep ? s / (1 - rate) : 0)
//   out[n]   = h16(a[n] . vpb)                                          (K3)
//
// K4 recomputes s and the mask and gives, with g the cotangent of out:
//   dvpb = a^T g,   da = keep ? (g . vpb^T) / (1 - rate) : 0,
//   ds   = h16(s * (da - sum_segment(da * s))),
//   dqn  = h16(ds . kpb^T),   dkpb = qn^T ds                 (f32 sums)
// kpb and vpb are taken as general matrices (no block-diagonal zeros are
// assumed). The rounding points are the TPU kernel's: f32 logits, s, da
// and sums; h16 a, out, ds and dqn; ds takes the pre-dropout s.
//
// Dropout: keep iff fmix32(idx * 0x9E3779B1 ^ key) >= rate * 2^32, where
// idx = ((b0 + b) * N + n) * hP + column (mod 2^32), key mixes the step's
// seed with the layer's salt, and b0 is the global index of the call's
// first sample (0 but on a data mesh's ranks, which pass
// xbase = b0 N hP 0x9E3779B1, so each sample keeps its single-device
// mask). It is a counter-based hash, so K4 regenerates K3's
// mask exactly, and kernels/spatial_attn.py computes the same bits with
// int64 torch ops for the plain version.
//
// What bounds them (H100: 989 TFLOP/s h16, 3.35 TB/s): per token K3 does
// 4 C hP operations on 4 C bytes (qn in, out back), K4 10 C hP on 6 C:
// at hP = 256, 256 and 427 operations a byte, at the card's balance point
// (~295). At level 3 (B = 4, N = 32768, C = 32) the bound is 5 us (K3,
// bytes) and 11 us (K4, operations). Beside the products each element of
// the B x N x hP attention tile (34 M at level 3) costs an exp on the SFU
// and the dropout hash, ~10 integer operations (keep_x), on the CUDA
// cores; that elementwise work, not the tensor cores, is what bounds these
// kernels in practice (kernels/spattn_sweep.py times them at rate 0 and
// 0.1). The design:
//   * Every product is mma.sync m16n8k16 (h16 operands from ldmatrix, f32
//     accumulators); the attention tile never leaves the chip. A warp owns
//     16 tokens and walks the heads: the logits' accumulator fragments are
//     the softmax's operands (quad shuffles along each row, exp2 on the
//     SFU), the mask is hashed once per element (K3 applies it at once; K4
//     keeps it as a 32-bit mask for a and da), and the rounded
//     probabilities are the next product's A operand in registers.
//   * K3: a block (token chunk, batch) stages kpb and vpb once (cp.async),
//     and each warp walks units of 16 tokens x CO output columns with its
//     16 x CO accumulator in registers; CO = C up to 128, and at C = 256
//     two units per token tile split the columns, each recomputing the
//     cheap logits. The output goes out through the warp's staged token
//     tile as 16-byte stores. One launch.
//   * K4: a block (token chunk, head group, batch) owns HB heads' columns
//     of kpb and vpb, staged once, and walks its chunk's T-token tiles
//     (the next tile's qn and g arrive by cp.async while this one
//     multiplies). Per tile each warp's 16 tokens give logits, s, the
//     mask, a, da (g . vpb^T), ds and dqn, all five products in fragments;
//     a and ds go to shared memory in h16 and come back by
//     ldmatrix.trans as the A^T operands of the token-contracted sums
//     dvpb += a^T g and dkpb += qn^T ds, whose C x HB*P tiles stay in
//     registers over the chunk, split over the block's eight warps (at
//     most 64 f32 a thread; a sum of fewer than 16 m16n8 tiles goes to the
//     first warps, a pair each). HB <= 8192 / (C P) heads fit that (level
//     3: all four, the whole row; level 4: two; levels 5-6: one, a split
//     by head). dqn sums over every head, so a block that owns all of them
//     stores it in h16, and otherwise writes one f32 partial per head
//     group.
//   * Widths: C a power of two from 16 to 256, P 16, 32 or 64, C P <= 8192
//     (SHAPES_FWD / SHAPES_BWD below): the default model's levels and the
//     narrower ones of smaller feature and projection sizes. Every other
//     (C, P) that B5 takes (C 8 .. 512, P 16 .. 128: segresnet_deeper's
//     (256, 64), MS_DSA_NET's fs32 and project-128 levels) runs the wide
//     instances at the end of this file (C15): flash-attention-like row
//     blocks of 32 tokens with every head's softmax on the fragments, and
//     K4's token sums in a kernel of their own. Instanced on f32 operands
//     (3xTF32 on the tensor cores), the same kernels are K3/K4 in f32 at
//     every one of B5's (C, P) (C18: a model that computes in f32).
//   * No atomics: each chunk writes one f32 partial of dkpb and dvpb, and
//     spatial_attn_bwd_finish adds the chunks' partials (and the head
//     groups' dqn partials) in a fixed order, writing dkpb and dvpb in
//     the dtype the caller asks for (f32 or h16) and dqn in h16. Two
//     calls give the same bits; one K4 call is two launches.
//   * Tiles, chunks and head groups come from kernels/spatial_attn.py::
//     spatial_attn_plan (pure Python); the launchers take its numbers.
//     kernels/spattn_sweep.py --plans times the alternatives on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "h16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int NT = 256;            // threads of a product block
constexpr int NW = NT / 32;
constexpr int FT = 256;            // threads of a finishing-pass block
constexpr int SMEM_CAP = 232448;   // shared memory one block may hold
constexpr int MAX_TILE = 16 * NW;  // K4 tokens a step: one m-tile a warp
constexpr float LOG2E = 1.4426950408889634f;

// a h16 row pitch of at least n elements: a multiple of 8 elements that
// is an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads sit in
// distinct banks (kernels/spatial_attn.py::_pitch)
__host__ __device__ constexpr int pitch(int n) {
  return (n + 7) / 8 * 8 + (((n + 7) / 8) % 2 == 0 ? 8 : 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte cp.async; valid false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// rows x cols h16 (cols % 8 == 0) from src (row stride ld elements) into
// shared dst (pitch dp) by cp.async, rows >= valid zero-filled
__device__ void stage(const h16* src, int ld, int rows, int valid, int cols,
                      h16* dst, int dp) {
  const int vr = cols / 8;
  for (int v = threadIdx.x; v < rows * vr; v += blockDim.x) {
    const int r = v / vr, c = (v - r * vr) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * dp + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

struct Drop {
  uint32_t key1;    // key ^ (key >> 16), see keep_x
  uint32_t xb;      // b0 N hP K0: the first sample's global index, hashed
  uint32_t thresh;
  float inv;        // 1 / (1 - rate); 1 without dropout
  int on;
};

constexpr uint32_t K0 = 0x9E3779B1u;  // the hash's index multiplier

// keep iff fmix32(x ^ key) >= thresh, x = idx * K0. fmix32's first
// xor-shift of x ^ key is x ^ (x >> 16) ^ key1 (a shift distributes over
// xor), so the key costs no operation of its own.
__device__ __forceinline__ bool keep_x(uint32_t x, const Drop& d) {
  x += d.xb;
  uint32_t h = x ^ (x >> 16) ^ d.key1;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h >= d.thresh;
}

// x = idx * K0 of attention element (token n, column q) of batch item b;
// the element q + k has x + k * K0 (mod 2^32), one addition
__device__ __forceinline__ uint32_t elem_x(int b, int N, int HP, int n,
                                           int q) {
  return (((uint32_t)b * (uint32_t)N + (uint32_t)n) * (uint32_t)HP +
          (uint32_t)q) * K0;
}

// The keep bits of this lane's fragments of a 16 x P tile of the
// attention (tokens n0.., columns q0..): bit 4j + e for element e of
// n-tile j (rows g, g, g + 8, g + 8; columns 2t, 2t + 1, 2t, 2t + 1).
template <int P>
__device__ __forceinline__ uint32_t keep_bits(const Drop& d, int b, int N,
                                              int HP, int n0, int q0,
                                              int lane) {
  static_assert(P / 8 * 4 <= 32, "one bit a fragment element");
  if (!d.on) return 0xffffffffu;
  const int g = lane >> 2, t = lane & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint32_t x = elem_x(b, N, HP, n0 + g + 8 * hf, q0 + 2 * t);
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (keep_x(x + (uint32_t)(8 * j + e) * K0, d))
          bits |= 1u << (4 * j + 2 * hf + e);
  }
  return bits;
}

// 2^x on the SFU; results below 2^-126 flush to 0 (softmax terms under
// 1e-38 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s (16 x P, this lane's fragments) <- exp(s - row max); inv0 / inv1 <- 1
// over the row sums of rows g and g + 8 (f32). EXACT: expf (the f32
// instances), else 2^x on the SFU.
template <int P, bool EXACT = false>
__device__ __forceinline__ void softmax_rows(float (&s)[P / 8][4],
                                             float& inv0, float& inv1) {
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
  const float m0 = mx0 * LOG2E, m1 = mx1 * LOG2E;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    if constexpr (EXACT) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
    } else {
      s[j][0] = ex2(fmaf(s[j][0], LOG2E, -m0));
      s[j][1] = ex2(fmaf(s[j][1], LOG2E, -m0));
      s[j][2] = ex2(fmaf(s[j][2], LOG2E, -m1));
      s[j][3] = ex2(fmaf(s[j][3], LOG2E, -m1));
    }
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
  }
  inv0 = 1.f / sum0;
  inv1 = 1.f / sum1;
}

// s (16 x P) <- A (16 x C at A, pitch ap) . B[:, q0 .. q0 + P] (B at Bs,
// stored C x (pitch bp) row-major: the B operand by ldmatrix.trans)
template <int C, int P>
__device__ __forceinline__ void logits(float (&s)[P / 8][4], const h16* A,
                                       int ap, const h16* Bs, int bp,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * ap + kk * 16 + (lane >> 4) * 8);
    const h16* brow = Bs + (kk * 16 + (lane & 15)) * bp + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < P / 8; j += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, brow + j * 8);
      mma16816(s[j], a, bb[0], bb[1]);
      mma16816(s[j + 1], a, bb[2], bb[3]);
    }
  }
}

// the A operand of k-step kk from 16 x P fragments v (n-tiles 2kk, 2kk+1)
template <int P>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const float (&v)[P / 8][4], int kk) {
  a[0] = pack2(v[2 * kk][0], v[2 * kk][1]);
  a[1] = pack2(v[2 * kk][2], v[2 * kk][3]);
  a[2] = pack2(v[2 * kk + 1][0], v[2 * kk + 1][1]);
  a[3] = pack2(v[2 * kk + 1][2], v[2 * kk + 1][3]);
}

// v (16 x P fragments) -> rows r0 .. r0 + 15 of D (pitch dp) from column q0,
// in h16
template <int P>
__device__ __forceinline__ void store_frags(h16* D, int dp, int r0, int q0,
                                            const float (&v)[P / 8][4],
                                            int lane) {
  const int r = r0 + (lane >> 2), c = q0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    *reinterpret_cast<uint32_t*>(D + r * dp + c + 8 * j) =
        pack2(v[j][0], v[j][1]);
    *reinterpret_cast<uint32_t*>(D + (r + 8) * dp + c + 8 * j) =
        pack2(v[j][2], v[j][3]);
  }
}

// ---- K3 ----------------------------------------------------------------------

struct FwdParams {
  const h16* qn;   // (B, N, C)
  const h16* kpb;  // (B, C, HP)
  const h16* vpb;  // (B, HP, C)
  h16* out;        // (B, N, C)
  int N, HP;
  int units;        // warp units a batch item: ceil(N / 16) x C / CO
  int per_block;    // units a block walks
  Drop d;
};

__host__ __device__ constexpr int fwd_smem(int C, int HP) {
  return 2 * (C * pitch(HP) + HP * pitch(C) + NW * 16 * pitch(C));
}

// grid (token chunk, batch)
template <int C, int P, int CO>
__global__ void __launch_bounds__(NT) spatial_attn_fwd_kernel(
    const FwdParams p) {
  constexpr int GROUPS = C / CO;
  constexpr int CP = pitch(C);
  const int HP = p.HP, H = HP / P, kp = pitch(HP);
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  h16* Ks = reinterpret_cast<h16*>(smem_raw);  // C x kp: kpb[b]
  h16* Vs = Ks + C * kp;                        // HP x CP: vpb[b]
  h16* Qw = Vs + HP * CP + warp * 16 * CP;      // this warp's 16 tokens
  stage(p.kpb + (size_t)b * C * HP, HP, C, C, HP, Ks, kp);
  stage(p.vpb + (size_t)b * HP * C, C, HP, HP, C, Vs, CP);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int u_end = min((blockIdx.x + 1) * p.per_block, p.units);
  for (int u = blockIdx.x * p.per_block + warp; u < u_end; u += NW) {
    const int n0 = (u / GROUPS) * 16, c0 = (u % GROUPS) * CO;
    const h16* qb = p.qn + ((size_t)b * p.N + n0) * C;
    for (int v = lane; v < 16 * (C / 8); v += 32) {
      const int r = v / (C / 8), c = (v - r * (C / 8)) * 8;
      const bool ok = n0 + r < p.N;
      cp_async16(Qw + r * CP + c, ok ? qb + (size_t)r * C + c : qb, ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    float o[CO / 8][4];
#pragma unroll
    for (int j = 0; j < CO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      float s[P / 8][4], inv0, inv1;
      logits<C, P>(s, Qw, CP, Ks + hh * P, kp, lane);
      softmax_rows<P>(s, inv0, inv1);
      // a = keep ? s / (1 - rate) : 0, one multiply an element
      const float f0 = inv0 * p.d.inv, f1 = inv1 * p.d.inv;
      if (p.d.on) {
        const int g = lane >> 2, q = hh * P + 2 * (lane & 3);
        const uint32_t x0 = elem_x(b, p.N, HP, n0 + g, q);
        const uint32_t x1 = elem_x(b, p.N, HP, n0 + g + 8, q);
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t k = (uint32_t)(8 * j + e) * K0;
            s[j][e] = keep_x(x0 + k, p.d) ? s[j][e] * f0 : 0.f;
            s[j][2 + e] = keep_x(x1 + k, p.d) ? s[j][2 + e] * f1 : 0.f;
          }
      } else {
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          s[j][0] *= f0;
          s[j][1] *= f0;
          s[j][2] *= f1;
          s[j][3] *= f1;
        }
      }
      // o += h16(a) . vpb[hh*P .., c0 ..] (B by ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t a[4];
        frag_a<P>(a, s, kk);
        const h16* brow = Vs + (hh * P + kk * 16 + (lane & 15)) * CP + c0 +
                           (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < CO / 8; j += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, brow + j * 8);
          mma16816(o[j], a, bb[0], bb[1]);
          mma16816(o[j + 1], a, bb[2], bb[3]);
        }
      }
    }
    // out = h16(o), staged in the warp's token rows, stored 16 bytes a lane
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      const int r = lane >> 2, c = j * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(Qw + r * CP + c) = pack2(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(Qw + (r + 8) * CP + c) =
          pack2(o[j][2], o[j][3]);
    }
    __syncwarp();
    for (int v = lane; v < 16 * (CO / 8); v += 32) {
      const int r = v / (CO / 8), c = (v - r * (CO / 8)) * 8;
      if (n0 + r < p.N)
        *reinterpret_cast<uint4*>(p.out + ((size_t)b * p.N + n0 + r) * C +
                                  c0 + c) =
            *reinterpret_cast<const uint4*>(Qw + r * CP + c);
    }
    __syncwarp();
  }
}

// ---- K4 ----------------------------------------------------------------------

struct BwdParams {
  const h16* qn;   // (B, N, C)
  const h16* kpb;  // (B, C, HP)
  const h16* vpb;  // (B, HP, C)
  const h16* g;    // (B, N, C) cotangent of out
  h16* dqn;        // (B, N, C), when a block owns every head
  float* dq_part;   // (HP / (HB P), B, N, C), else: one per head group
  float* dk_part;   // (chunks, B, C, HP)
  float* dv_part;   // (chunks, B, HP, C)
  int N, HP, T, tiles, chunks;
  Drop d;
};

__host__ __device__ constexpr int bwd_smem(int C, int HBP, int T) {
  return 2 * (C * pitch(HBP) + HBP * pitch(C) + 4 * T * pitch(C) +
              2 * T * pitch(HBP));
}

// acc (R x NC m16n8 tiles of an M x N output, rows m_base.., columns
// n_base..) += A^T . B over the 16 tokens from row t0: A stored T x (pitch
// ap) with the M index along its rows, B stored T x (pitch bp); both by
// ldmatrix.trans
template <int R, int NC>
__device__ __forceinline__ void token_sum(float (&acc)[R * NC][4],
                                          const h16* A, int ap, const h16* B,
                                          int bp, int t0, int m_base,
                                          int n_base, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t a[4];
    ldsm_x4_t(a, A + (t0 + (lane & 7) + ((lane >> 4) << 3)) * ap +
                     (m_base + r) * 16 + ((lane >> 3) & 1) * 8);
    const h16* brow = B + (t0 + (lane & 15)) * bp + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NC; j += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, brow + (n_base + j) * 8);
      mma16816(acc[r * NC + j], a, bb[0], bb[1]);
      mma16816(acc[r * NC + j + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (R x NC m16n8 tiles) -> rows m_base * 16 .., columns n_base * 8 .. +
// col0 of dst (f32, row stride ld)
template <int R, int NC>
__device__ __forceinline__ void store_acc(float* dst, int ld, int col0,
                                          const float (&acc)[R * NC][4],
                                          int m_base, int n_base, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = (m_base + r) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = col0 + (n_base + j) * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + (size_t)row * ld + col) =
          make_float2(acc[r * NC + j][0], acc[r * NC + j][1]);
      *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * ld + col) =
          make_float2(acc[r * NC + j][2], acc[r * NC + j][3]);
    }
  }
}

// How a warp's share of an M x N output (m16n8 tiles) lies: NJ tiles, as
// R rows of NC consecutive tiles each. At least a pair of tiles a warp:
// where the output has fewer than 2 NW tiles, only the first ACTIVE warps
// own a share.
template <int M, int N>
struct Split {
  static constexpr int TILES_N = N / 8;
  static constexpr int TOTAL = (M / 16) * TILES_N;
  static constexpr int NJ = TOTAL / NW >= 2 ? TOTAL / NW : 2;
  static constexpr int ACTIVE = TOTAL / NJ;
  static constexpr int NC = NJ < TILES_N ? NJ : TILES_N;
  static constexpr int R = NJ / NC;
  static_assert(TOTAL % NJ == 0 && NJ % NC == 0 && NC % 2 == 0 &&
                    (TILES_N % NC == 0),
                "the warps split the output into whole pairs of tiles");
  __device__ static int m_base(int warp) { return warp * NJ / TILES_N; }
  __device__ static int n_base(int warp) { return warp * NJ % TILES_N; }
};

// grid (chunk, head group, batch)
template <int C, int P, int HB>
__global__ void __launch_bounds__(NT, 1) spatial_attn_bwd_kernel(
    const BwdParams p) {
  constexpr int HBP = HB * P;
  constexpr int CP = pitch(C), BP = pitch(HBP);
  using SK = Split<C, HBP>;  // dkpb: C x HBP
  using SV = Split<HBP, C>;  // dvpb: HBP x C
  const int HP = p.HP, T = p.T, N = p.N;
  const int chunk = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = hg * HBP;  // the block's first column of kpb
  extern __shared__ __align__(16) unsigned char smem_raw[];
  h16* Ks = reinterpret_cast<h16*>(smem_raw);  // C x BP: kpb[b][:, q0 ..]
  h16* Vs = Ks + C * BP;                        // HBP x CP: vpb[b][q0 .., :]
  h16* QG = Vs + HBP * CP;  // two stages of (qn | g) tiles, T x CP each
  h16* As = QG + 4 * T * CP;                    // T x BP: a
  h16* Ds = As + T * BP;                        // T x BP: ds

  const int t_begin = chunk * p.tiles / p.chunks;
  const int t_end = (chunk + 1) * p.tiles / p.chunks;
  auto load_tile = [&](int tile, int stg) {
    const int n0 = tile * T;
    const size_t off = ((size_t)b * N + n0) * C;
    h16* q = QG + stg * 2 * T * CP;
    stage(p.qn + off, C, T, N - n0, C, q, CP);
    stage(p.g + off, C, T, N - n0, C, q + T * CP, CP);
  };
  stage(p.kpb + (size_t)b * C * HP + q0, HP, C, C, HBP, Ks, BP);
  stage(p.vpb + ((size_t)b * HP + q0) * C, C, HBP, HBP, C, Vs, CP);
  load_tile(t_begin, 0);
  cp_async_commit();

  float ak[SK::NJ][4], av[SV::NJ][4];
#pragma unroll
  for (int j = 0; j < SK::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < SV::NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = 0.f;

  for (int tile = t_begin, stg = 0; tile < t_end; ++tile, stg ^= 1) {
    const int n0 = tile * T;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the last tile's sums are done
    if (tile + 1 < t_end) {
      load_tile(tile + 1, stg ^ 1);
      cp_async_commit();
    }
    const h16* Qs = QG + stg * 2 * T * CP;
    const h16* Gs = Qs + T * CP;

    // per warp 16 tokens: logits, s, mask, a, da, ds, dqn
    for (int mt = warp; mt < T / 16; mt += NW) {
      const h16* Qw = Qs + mt * 16 * CP;
      const h16* Gw = Gs + mt * 16 * CP;
      const int nw = n0 + mt * 16;
      float dq[HB > 1 ? C / 8 : 1][4];
#pragma unroll
      for (int j = 0; j < (HB > 1 ? C / 8 : 1); ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll
      for (int hl = 0; hl < HB; ++hl) {
        const int col = hl * P;  // the head's first column in the block
        float s[P / 8][4], inv0, inv1;
        logits<C, P>(s, Qw, CP, Ks + col, BP, lane);
        softmax_rows<P>(s, inv0, inv1);
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          s[j][0] *= inv0;
          s[j][1] *= inv0;
          s[j][2] *= inv1;
          s[j][3] *= inv1;
        }
        const uint32_t keep =
            keep_bits<P>(p.d, b, N, HP, nw, q0 + col, lane);
        {  // a = h16(keep ? s * inv : 0), to As
          float a[P / 8][4];
#pragma unroll
          for (int j = 0; j < P / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[j][e] = (keep >> (4 * j + e)) & 1u ? s[j][e] * p.d.inv : 0.f;
          store_frags<P>(As, BP, mt * 16, col, a, lane);
        }
        // da = g . vpb^T over the head's columns (B: Vs rows, no trans)
        float da[P / 8][4];
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, Gw + (lane & 15) * CP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < P / 8; j += 2) {
            uint32_t bb[4];
            ldsm_x4(bb, Vs + (col + j * 8 + (lane >> 4) * 8 + (lane & 7)) * CP +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma16816(da[j], a, bb[0], bb[1]);
            mma16816(da[j + 1], a, bb[2], bb[3]);
          }
        }
        // ds = h16(s * (da - sum_row(da * s))), da masked and scaled
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int j = 0; j < P / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            da[j][e] = (keep >> (4 * j + e)) & 1u ? da[j][e] * p.d.inv : 0.f;
            if (e < 2)
              dot0 = fmaf(da[j][e], s[j][e], dot0);
            else
              dot1 = fmaf(da[j][e], s[j][e], dot1);
          }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          dot0 += __shfl_xor_sync(0xffffffffu, dot0, x);
          dot1 += __shfl_xor_sync(0xffffffffu, dot1, x);
        }
#pragma unroll
        for (int j = 0; j < P / 8; ++j) {
          da[j][0] = s[j][0] * (da[j][0] - dot0);
          da[j][1] = s[j][1] * (da[j][1] - dot0);
          da[j][2] = s[j][2] * (da[j][2] - dot1);
          da[j][3] = s[j][3] * (da[j][3] - dot1);
        }
        store_frags<P>(Ds, BP, mt * 16, col, da, lane);
        // dqn (16 x C) += ds . kpb^T over the head's columns (B: Ks rows)
        uint32_t dsa[P / 16][4];
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) frag_a<P>(dsa[kk], da, kk);
        if constexpr (HB > 1) {
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
            for (int j = 0; j < C / 8; j += 2) {
              uint32_t bb[4];
              ldsm_x4(bb, Ks + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * BP +
                              col + kk * 16 + ((lane >> 3) & 1) * 8);
              mma16816(dq[j], dsa[kk], bb[0], bb[1]);
              mma16816(dq[j + 1], dsa[kk], bb[2], bb[3]);
            }
        } else {  // one head a block: its dqn partial, streamed out
          float* dst = p.dq_part + (((size_t)hg * gridDim.z + b) * N + nw) * C;
          const int r = lane >> 2;
#pragma unroll 4
          for (int j = 0; j < C / 8; j += 2) {
            float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk) {
              uint32_t bb[4];
              ldsm_x4(bb, Ks + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * BP +
                              col + kk * 16 + ((lane >> 3) & 1) * 8);
              mma16816(o[0], dsa[kk], bb[0], bb[1]);
              mma16816(o[1], dsa[kk], bb[2], bb[3]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int c = (j + i) * 8 + 2 * (lane & 3);
              if (nw + r < N)
                *reinterpret_cast<float2*>(dst + (size_t)r * C + c) =
                    make_float2(o[i][0], o[i][1]);
              if (nw + r + 8 < N)
                *reinterpret_cast<float2*>(dst + (size_t)(r + 8) * C + c) =
                    make_float2(o[i][2], o[i][3]);
            }
          }
        }
      }
      if constexpr (HB > 1) {
        const int r = lane >> 2;
        const size_t row0 = (size_t)b * N + nw;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int c = j * 8 + 2 * (lane & 3);
          if (p.dqn) {  // every head: dqn itself
            if (nw + r < N)
              *reinterpret_cast<uint32_t*>(p.dqn + (row0 + r) * C + c) =
                  pack2(dq[j][0], dq[j][1]);
            if (nw + r + 8 < N)
              *reinterpret_cast<uint32_t*>(p.dqn + (row0 + r + 8) * C + c) =
                  pack2(dq[j][2], dq[j][3]);
          } else {
            float* dst = p.dq_part + (size_t)hg * gridDim.z * N * C;
            if (nw + r < N)
              *reinterpret_cast<float2*>(dst + (row0 + r) * C + c) =
                  make_float2(dq[j][0], dq[j][1]);
            if (nw + r + 8 < N)
              *reinterpret_cast<float2*>(dst + (row0 + r + 8) * C + c) =
                  make_float2(dq[j][2], dq[j][3]);
          }
        }
      }
    }
    __syncthreads();  // a and ds of every token of the tile are in place

    // dkpb (C x HBP) += qn^T ds, dvpb (HBP x C) += a^T g, over the tile
    const int mk = SK::m_base(warp), nk = SK::n_base(warp);
    const int mv = SV::m_base(warp), nv = SV::n_base(warp);
    for (int t0 = 0; t0 < T; t0 += 16) {
      if (warp < SK::ACTIVE)
        token_sum<SK::R, SK::NC>(ak, Qs, CP, Ds, BP, t0, mk, nk, lane);
      if (warp < SV::ACTIVE)
        token_sum<SV::R, SV::NC>(av, As, BP, Gs, CP, t0, mv, nv, lane);
    }
  }
  // this chunk's partials
  const size_t slot = (size_t)chunk * gridDim.z + b;
  if (warp < SK::ACTIVE)
    store_acc<SK::R, SK::NC>(p.dk_part + slot * C * HP, HP, q0, ak,
                             SK::m_base(warp), SK::n_base(warp), lane);
  if (warp < SV::ACTIVE)
    store_acc<SV::R, SV::NC>(p.dv_part + (slot * HP + q0) * C, C, 0, av,
                             SV::m_base(warp), SV::n_base(warp), lane);
}

// ---- K4's finishing pass -------------------------------------------------------

struct FinishParams {
  const float* dk_part;  // (chunks, n_kv)
  const float* dv_part;  // (chunks, n_kv)
  const float* dq_part;  // (groups, n_q) or null
  void* dk;              // n_kv, f32 or h16
  void* dv;
  void* dqn;             // n_q, h16 (the f32 instances: f32)
  int chunks, groups;
  long long n_kv, n_q;   // elements, multiples of 4
  int dk_h16, dv_h16, dq_h16;
};

// sum over k < count of src[k * stride + i .. + 4], in the order k = 0, 1,
// ...; eight loads in flight
__device__ __forceinline__ float4 ordered_sum(const float* src, long long i,
                                              int count, long long stride) {
  float4 acc = *reinterpret_cast<const float4*>(src + i);
  for (int k0 = 1; k0 < count; k0 += 8) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < count)
        x[u] = *reinterpret_cast<const float4*>(src + (k0 + u) * stride + i);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < count) {
        acc.x += x[u].x;
        acc.y += x[u].y;
        acc.z += x[u].z;
        acc.w += x[u].w;
      }
  }
  return acc;
}

__device__ __forceinline__ void store4(void* dst, int is_h16, long long i,
                                       float4 v) {
  if (is_h16)
    *reinterpret_cast<uint2*>(static_cast<h16*>(dst) + i) =
        make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(dst) + i) = v;
}

// one thread a 4-vector of dkpb, then of dvpb, then of dqn
__global__ void __launch_bounds__(FT) spatial_attn_bwd_finish(
    const FinishParams p) {
  const long long v = (long long)blockIdx.x * FT + threadIdx.x;
  const long long kv4 = p.n_kv / 4;
  if (v < kv4) {
    store4(p.dk, p.dk_h16, 4 * v, ordered_sum(p.dk_part, 4 * v, p.chunks,
                                               p.n_kv));
  } else if (v < 2 * kv4) {
    const long long i = 4 * (v - kv4);
    store4(p.dv, p.dv_h16, i, ordered_sum(p.dv_part, i, p.chunks, p.n_kv));
  } else if (p.groups > 0 && v < 2 * kv4 + p.n_q / 4) {
    const long long i = 4 * (v - 2 * kv4);
    store4(p.dqn, p.dq_h16, i, ordered_sum(p.dq_part, i, p.groups, p.n_q));
  }
}

// ---- the wide instances (C15), and the f32 instances (C18) -----------------
//
// Every (C, P) with C a power of two from 8 to 512 and P 16 .. 128 that the
// tensor-core instances above do not take (C = 8, C = 512, P = 128, and C P
// > 8192: SHAPES_WIDE in kernels/spatial_attn.py), in h16; and, on f32
// operands, every (C, P) of B5's set: a model that computes in f32 runs
// the JAX package's spatial_attn_train in f32, where every 16-bit rounding
// point is a no-op (fcd_tpu/kernels/spatial_attn.py:83,113,131, ROADMAP
// C18). 1, 2 or 4 heads.
//
// Above C P = 8192 a block can no longer hold a head's dkpb and dvpb sums
// in registers, nor, at (512, 128), a head's kpb columns beside its vpb
// rows in shared memory (128 KB each in h16). These kernels therefore read
// K3 and K4 as flash attention does, as GEMMs around a softmax that stays
// in registers, with every product on the tensor cores:
//   * A row block of WTOK = 32 tokens owns every head of its tokens. Its
//     eight warps each take one (16-token m-tile, head) unit of the
//     logits, s = qn . kpb (and K4's da = g . vpb^T), as mma fragments;
//     kpb's rows (vpb's columns) stream through shared memory kc at a
//     time, two stages by cp.async, while the last chunk multiplies. The
//     softmax, the dropout hash and (K4) ds run on the fragments. The
//     rounded a (K3) or ds (K4) then overlay the token tiles in shared
//     memory as the A operand of the second product, out = a . vpb (K3)
//     or dqn = ds . kpb^T (K4), whose B operand streams kq rows of hP at a
//     time; its 32 x C sum is split over the warps (at most 64 f32 a
//     thread). No head is computed twice, and dqn is summed over every
//     head in one accumulator and written once, rounded: no dqn partials.
//   * K4's token-contracted sums, dkpb = qn^T ds and dvpb = a^T g, are a
//     second kernel (spatial_attn_bwd_sums_wide): the row blocks write a
//     and ds (B, N, hP) in the operands' type, and each sums block takes
//     a 64 x 64 tile of dkpb^T or dvpb (hP x C) and walks its chunk of the
//     tokens, 64 a step (each step summed on the tensor cores from zero,
//     then added to the chunk's sum in IEEE f32); each chunk writes an f32
//     partial that
//     spatial_attn_bwd_finish adds in chunk order (no atomics: two calls
//     give the same bits). One K4 call is three launches.
//   * h16 operands: mma.sync m16n8k16 from ldmatrix (row pitches off the
//     banks' period, as in the kernels above). f32 operands: 3xTF32, the
//     mma.sync m16n8k8 .tf32 product of each operand's TF32 high part and
//     the TF32 rounding of its rest, hi.lo + lo.hi + hi.hi summed in the
//     f32 accumulators (the dropped lo.lo is 2^-22 of the product), the
//     fragments read by scalar loads; softmax with expf. The rounding
//     points are those of the plain version: f32 logits, s and da; a, out,
//     ds and dqn in the operands' type; ds from the pre-dropout s.
// Shared memory, chunk sizes and grids come from kernels/spatial_attn.py::
// wide_plan (pure Python); wide_ok checks what it gives.

constexpr int WT = 256;       // threads of a wide block: eight warps
constexpr int WTOK = 32;      // tokens of a row block: two m-tiles
constexpr int WSUM_T = 64;    // the token sums: tokens a step
constexpr int WSUM_Q = 64;    // their tile: hP rows at most
constexpr int WSUM_C = 64;    // and C columns at most

// the wide kernels' C as staged: padded with zero columns to 16
__host__ __device__ constexpr int wide_ck(int C) { return C < 16 ? 16 : C; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Row pitches (elements) of a staged tile of n columns: for h16 operands
// pitch() (the 8 rows an ldmatrix reads sit in distinct banks); for f32
// operands, read by scalar loads in the fragments' pattern, an odd
// multiple of 4 where a lane's fragment runs along the tile's rows (A
// stored M x K, B stored N x K: lane (g, t) reads row g, column t) and an
// odd multiple of 8 where it runs along its columns (A stored K x M, B
// stored K x N: row t, column g), so the 32 lanes read 32 banks.
__host__ __device__ constexpr int pitch_rows(int es, int n) {
  return es == 2 ? pitch(n) : (n + 7) / 8 * 8 + 4;
}
__host__ __device__ constexpr int pitch_cols(int es, int n) {
  return es == 2 ? pitch(n) : (n + 15) / 16 * 16 + 8;
}

// elements of one stage of a row block's streamed operand: kc rows of kpb,
// kc columns of vpb (K4), kq rows of vpb (K3) or kq columns of kpb (K4)
__host__ __device__ constexpr int wide_stage(int es, int bwd, int C, int HP,
                                             int kc, int kq) {
  return imax(imax(kc * pitch_cols(es, HP), bwd ? HP * pitch_rows(es, kc) : 0),
              bwd ? wide_ck(C) * pitch_rows(es, kq)
                  : kq * pitch_cols(es, wide_ck(C)));
}

// elements before the stages: the qn tile (and K4's g tile), which a or
// ds (WTOK x hP) overlays once the logits are done
__host__ __device__ constexpr int wide_tiles(int es, int bwd, int C, int HP) {
  return imax(WTOK * pitch_rows(es, wide_ck(C)) * (bwd ? 2 : 1),
              WTOK * pitch_rows(es, HP));
}

// a row block's shared memory (bytes)
__host__ __device__ constexpr int wide_rows_smem(int es, int bwd, int C,
                                                 int HP, int kc, int kq) {
  return es * (wide_tiles(es, bwd, C, HP) + 2 * wide_stage(es, bwd, C, HP,
                                                          kc, kq));
}

// a sums block's: two stages of WSUM_T tokens of a or ds (its tile's hP
// columns) and of qn or g (its C columns)
__host__ __device__ constexpr int wide_sums_smem(int es, int C, int HP) {
  return es * 2 * WSUM_T * (pitch_cols(es, imin(HP, WSUM_Q)) +
                            pitch_cols(es, imin(wide_ck(C), WSUM_C)));
}

// rows x cols elements (cols a multiple of 16 bytes) from src (row stride
// ld) into shared dst (pitch dp) by cp.async; an element of row >= vrows
// or column >= vcols (a multiple of 16 bytes) is zero
template <typename E>
__device__ __forceinline__ void stage_tile(E* dst, int dp, const E* src,
                                           int ld, int rows, int cols,
                                           int vrows, int vcols) {
  constexpr int V = 16 / sizeof(E);
  const int vr = cols / V;
  for (int v = threadIdx.x; v < rows * vr; v += WT) {
    const int r = v / vr, c = (v - r * vr) * V;
    const bool ok = r < vrows && c < vcols;
    cp_async16(dst + r * dp + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// chunks 0 .. n - 1 of a streamed operand through two stages: chunk i + 1
// is in flight while chunk i multiplies. The caller has issued chunk 0 to
// stage 0 (and committed it); on return every thread is done with both.
template <typename Stage, typename Use>
__device__ __forceinline__ void stream(int n, Stage stage, Use use) {
  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();
    __syncthreads();  // chunk i landed; chunk i - 1's stage is free
    if (i + 1 < n) {
      stage(i + 1, (i + 1) & 1);
      cp_async_commit();
    }
    use(i, i & 1);
  }
  __syncthreads();
}

// acc[j] (the m16n8 tile of rows m0 .. m0 + 15, columns n0 + 8 j .., j <
// nj) += A[m0 .., 0 .. k1) . B[0 .. k1, n0 ..), in shared memory: A stored
// M x K (row m at A + m ap) or, with AKM, K x M; B stored K x N or, with
// BNK, N x K. h16: m16n8k16 from ldmatrix (nj even); f32: 3xTF32 m16n8k8
// (csrc/tf32x3.cuh).
template <bool AKM, bool BNK, int MJ, typename E>
__device__ __forceinline__ void warp_mma(float (&acc)[MJ][4], int nj,
                                         const E* A, int ap, int m0,
                                         const E* B, int bp, int n0, int k1,
                                         int lane) {
  if constexpr (sizeof(E) == 2) {
    for (int k = 0; k < k1; k += 16) {
      uint32_t a[4];
      if constexpr (AKM)
        ldsm_x4_t(a, A + (k + (lane & 7) + ((lane >> 4) << 3)) * ap + m0 +
                         ((lane >> 3) & 1) * 8);
      else
        ldsm_x4(a, A + (m0 + (lane & 15)) * ap + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < MJ; j += 2) {
        if (j >= nj) break;
        uint32_t bb[4];
        if constexpr (BNK)
          ldsm_x4(bb, B + (n0 + j * 8 + (lane >> 4) * 8 + (lane & 7)) * bp +
                          k + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(bb, B + (k + (lane & 15)) * bp + n0 + j * 8 +
                            (lane >> 4) * 8);
        mma16816(acc[j], a, bb[0], bb[1]);
        mma16816(acc[j + 1], a, bb[2], bb[3]);
      }
    }
  } else {
    warp_mma_tf32<AKM, BNK, MJ>(acc, nj, A, ap, m0, B, bp, n0, k1, lane);
  }
}

// two adjacent elements, rounded to the operand type
__device__ __forceinline__ void store2(h16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = pack2(x, y);
}
__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

template <typename E>
struct WideRows {
  const E* qn;   // (B, N, C)
  const E* kpb;  // (B, C, HP)
  const E* vpb;  // (B, HP, C)
  const E* g;    // (B, N, C): K4's cotangent
  E* out;        // (B, N, C): K3's out, K4's dqn
  E* a;          // (B, N, HP): K4's a and ds, for the token sums
  E* ds;
  int N, C, HP, kc, kq;
  Drop d;
};

// grid (ceil(N / WTOK), batch): K3 (BWD false) or K4's row blocks
template <typename E, int P, bool BWD>
__device__ __forceinline__ void wide_rows(const WideRows<E>& p) {
  constexpr int ES = sizeof(E);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, HP = p.HP, N = p.N, CK = wide_ck(C), H = HP / P;
  const int kc = p.kc, kq = p.kq;
  const int b = blockIdx.y, n0 = blockIdx.x * WTOK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qp = pitch_rows(ES, CK), xp = pitch_rows(ES, HP);
  const int kp1 = pitch_cols(ES, HP), vp1 = pitch_rows(ES, kc);
  const int p2 = BWD ? pitch_rows(ES, kq) : pitch_cols(ES, CK);
  const int st = wide_stage(ES, BWD, C, HP, kc, kq);
  E* Qs = reinterpret_cast<E*>(smem_raw);  // WTOK x qp: qn's tile
  E* Gs = Qs + WTOK * qp;                  // WTOK x qp: g's (K4)
  E* Xs = Qs;  // WTOK x xp: a (K3) or ds (K4), once the logits are done
  E* St = Qs + wide_tiles(ES, BWD, C, HP);  // two stages of st
  const E* kb = p.kpb + (size_t)b * C * HP;
  const E* vb = p.vpb + (size_t)b * HP * C;
  const size_t row0 = (size_t)b * N + n0;
  stage_tile(Qs, qp, p.qn + row0 * C, C, WTOK, CK, N - n0, C);
  if constexpr (BWD) stage_tile(Gs, qp, p.g + row0 * C, C, WTOK, CK, N - n0, C);

  // warp w's unit: tokens um .. um + 15 of the block, head uh
  const int um = (warp & 1) * 16, uh = warp >> 1;
  const bool unit = uh < H;
  float s[P / 8][4], da[BWD ? P / 8 : 1][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // the logits, s = qn . kpb[:, head], kpb's rows kc at a time
  const int nk = CK / kc;
  auto stage_k = [&](int i, int buf) {
    stage_tile(St + buf * st, kp1, kb + (size_t)i * kc * HP, HP, kc, HP,
               C - i * kc, HP);
  };
  stage_k(0, 0);
  cp_async_commit();
  stream(nk, stage_k, [&](int i, int buf) {
    if (unit)
      warp_mma<false, false>(s, P / 8, Qs + i * kc, qp, um, St + buf * st,
                             kp1, uh * P, kc, lane);
  });
  if constexpr (BWD) {  // da = g . vpb^T, vpb's columns kc at a time
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) da[j][e] = 0.f;
    auto stage_v = [&](int i, int buf) {
      stage_tile(St + buf * st, vp1, vb + i * kc, C, HP, kc, HP, C - i * kc);
    };
    stage_v(0, 0);
    cp_async_commit();
    stream(nk, stage_v, [&](int i, int buf) {
      if (unit)
        warp_mma<false, true>(da, P / 8, Gs + i * kc, qp, um, St + buf * st,
                              vp1, uh * P, kc, lane);
    });
  }
  // the second product's first chunk flies while the softmax runs
  auto stage_o = [&](int i, int buf) {
    if constexpr (BWD)  // kq columns of kpb (dqn's B, N x K)
      stage_tile(St + buf * st, p2, kb + i * kq, HP, CK, kq, C, kq);
    else  // kq rows of vpb (out's B, K x N)
      stage_tile(St + buf * st, p2, vb + (size_t)i * kq * C, C, kq, CK, kq,
                 C);
  };
  stage_o(0, 0);
  cp_async_commit();

  if (unit) {
    float inv0, inv1;
    softmax_rows<P, ES == 4>(s, inv0, inv1);
    const int r0 = um + (lane >> 2);     // this lane's rows r0, r0 + 8
    const int q0 = uh * P + 2 * (lane & 3);  // and first column
    const uint32_t x0 = elem_x(b, N, HP, n0 + r0, q0);
    const uint32_t x1 = elem_x(b, N, HP, n0 + r0 + 8, q0);
    if constexpr (!BWD) {
      // a = keep ? s / (1 - rate) : 0, rounded, to Xs
      const float f0 = inv0 * p.d.inv, f1 = inv1 * p.d.inv;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep =
              !p.d.on ||
              keep_x((e < 2 ? x0 : x1) + (uint32_t)(8 * j + (e & 1)) * K0,
                     p.d);
          v[e] = keep ? s[j][e] * (e < 2 ? f0 : f1) : 0.f;
        }
        store2(Xs + r0 * xp + q0 + 8 * j, v[0], v[1]);
        store2(Xs + (r0 + 8) * xp + q0 + 8 * j, v[2], v[3]);
      }
    } else {
      // s, the mask, a (to the token sums' scratch) and da' = keep ? da /
      // (1 - rate) : 0; then ds = round(s (da' - sum(da' s))) to Xs and
      // the scratch
      const bool in0 = n0 + r0 < N, in1 = n0 + r0 + 8 < N;
      E* a0 = p.a + (row0 + r0) * HP + q0;
      E* d0 = p.ds + (row0 + r0) * HP + q0;
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= e < 2 ? inv0 : inv1;
          const bool keep =
              !p.d.on ||
              keep_x((e < 2 ? x0 : x1) + (uint32_t)(8 * j + (e & 1)) * K0,
                     p.d);
          v[e] = keep ? s[j][e] * p.d.inv : 0.f;
          da[j][e] = keep ? da[j][e] * p.d.inv : 0.f;
          if (e < 2)
            dot0 = fmaf(da[j][e], s[j][e], dot0);
          else
            dot1 = fmaf(da[j][e], s[j][e], dot1);
        }
        if (in0) store2(a0 + 8 * j, v[0], v[1]);
        if (in1) store2(a0 + 8 * HP + 8 * j, v[2], v[3]);
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        dot0 += __shfl_xor_sync(0xffffffffu, dot0, x);
        dot1 += __shfl_xor_sync(0xffffffffu, dot1, x);
      }
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        const float v0 = s[j][0] * (da[j][0] - dot0);
        const float v1 = s[j][1] * (da[j][1] - dot0);
        const float v2 = s[j][2] * (da[j][2] - dot1);
        const float v3 = s[j][3] * (da[j][3] - dot1);
        store2(Xs + r0 * xp + q0 + 8 * j, v0, v1);
        store2(Xs + (r0 + 8) * xp + q0 + 8 * j, v2, v3);
        if (in0) store2(d0 + 8 * j, v0, v1);
        if (in1) store2(d0 + 8 * HP + 8 * j, v2, v3);
      }
    }
  }

  // out (K3) or dqn (K4) = Xs (WTOK x hP) . the streamed operand, hP kq at
  // a time; warp (om, og) owns tokens om .., columns on0 .. on0 + 8 nj
  const int groups = imin(CK / 16, 4);
  const int om = (warp & 1) * 16, og = warp >> 1;
  const int width = CK / groups, nj = width / 8, on0 = og * width;
  const bool act = og < groups;
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  stream(HP / kq, stage_o, [&](int i, int buf) {
    if (act) warp_mma<false, BWD>(o, nj, Xs + i * kq, xp, om, St + buf * st,
                                  p2, on0, kq, lane);
  });
  if (!act) return;
  const int r = om + (lane >> 2);
  E* dst = p.out + (row0 + r) * C;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j >= nj) break;
    const int c = on0 + 8 * j + 2 * (lane & 3);
    if (c >= C) continue;
    if (n0 + r < N) store2(dst + c, o[j][0], o[j][1]);
    if (n0 + r + 8 < N) store2(dst + 8 * C + c, o[j][2], o[j][3]);
  }
}

template <typename E, int P>
__global__ void __launch_bounds__(WT)
    spatial_attn_fwd_kernel_wide(const WideRows<E> p) {
  wide_rows<E, P, false>(p);
}

template <typename E, int P>
__global__ void __launch_bounds__(WT)
    spatial_attn_bwd_kernel_wide(const WideRows<E> p) {
  wide_rows<E, P, true>(p);
}

template <typename E>
struct WideSums {
  const E* a;       // (B, N, HP)
  const E* ds;      // (B, N, HP)
  const E* qn;      // (B, N, C)
  const E* g;       // (B, N, C)
  float* dk_part;   // (chunks, B, C, HP)
  float* dv_part;   // (chunks, B, HP, C)
  int N, C, HP, tiles, chunks;
};

// grid (tile of hP x C, chunk, 2 batch): z even, dkpb^T = ds^T qn (stored
// transposed); z odd, dvpb = a^T g. Tokens past N are zero rows.
template <typename E>
__global__ void __launch_bounds__(WT)
    spatial_attn_bwd_sums_wide(const WideSums<E> p) {
  constexpr int ES = sizeof(E);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, HP = p.HP, N = p.N, CK = wide_ck(C);
  const int TQ = imin(HP, WSUM_Q), TC = imin(CK, WSUM_C), ctiles = CK / TC;
  const int q0 = blockIdx.x / ctiles * TQ, c0 = blockIdx.x % ctiles * TC;
  const int chunk = blockIdx.y, b = blockIdx.z >> 1, is_dv = blockIdx.z & 1;
  const int B = gridDim.z >> 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const E* X = (is_dv ? p.a : p.ds) + (size_t)b * N * HP;
  const E* Y = (is_dv ? p.g : p.qn) + (size_t)b * N * C;
  const int xp = pitch_cols(ES, TQ), yp = pitch_cols(ES, TC);
  E* Xs = reinterpret_cast<E*>(smem_raw);  // two stages, WSUM_T x xp
  E* Ys = Xs + 2 * WSUM_T * xp;            // two stages, WSUM_T x yp
  // warp (wm, wn): rows wm * 16 .. of the tile, columns wn * width ..
  const int halves = TC >= 32 ? 2 : 1;
  const int wm = warp & 3, wn = warp >> 2, width = TC / halves;
  const int nj = width / 8;
  const bool act = wm * 16 < TQ && wn < halves;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int t_begin = chunk * p.tiles / p.chunks;
  const int t_end = (chunk + 1) * p.tiles / p.chunks;
  auto stage = [&](int i, int buf) {
    const int t0 = (t_begin + i) * WSUM_T;
    stage_tile(Xs + buf * WSUM_T * xp, xp, X + (size_t)t0 * HP + q0, HP,
               WSUM_T, TQ, N - t0, TQ);
    stage_tile(Ys + buf * WSUM_T * yp, yp, Y + (size_t)t0 * C + c0, C,
               WSUM_T, TC, N - t0, C - c0);
  };
  stage(0, 0);
  cp_async_commit();
  // each step's 64 tokens are summed on the tensor cores from zero, and
  // the step's sum is added to the chunk's in IEEE f32: the tensor cores'
  // own accumulation then runs over 64 tokens at most, not the chunk's
  // thousands (level 3 in f32: rel 1.9e-5 of max |dkpb| one chain, PERF.md)
  stream(t_end - t_begin, stage, [&](int i, int buf) {
    if (!act) return;
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    warp_mma<true, false>(part, nj, Xs + buf * WSUM_T * xp, xp, wm * 16,
                          Ys + buf * WSUM_T * yp, yp, wn * width, WSUM_T,
                          lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  });
  if (!act) return;
  const size_t slot = (size_t)chunk * B + b;
  const int q = q0 + wm * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nj) break;
    const int c = c0 + wn * width + 8 * j + 2 * (lane & 3);
    if (c >= C) continue;
    if (is_dv) {
      float* d = p.dv_part + (slot * HP + q) * C + c;
      *reinterpret_cast<float2*>(d) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(d + 8 * C) = make_float2(acc[j][2],
                                                          acc[j][3]);
    } else {
      float* d = p.dk_part + (slot * C + c) * HP + q;
      d[0] = acc[j][0];
      d[HP] = acc[j][1];
      d[8] = acc[j][2];
      d[HP + 8] = acc[j][3];
    }
  }
}

// ---- launches --------------------------------------------------------------

// The shapes the kernels are built for (kernels/spatial_attn.py::SHAPES
// lists the same): C a power of two from 16 to 256, P 16, 32 or 64, with
// C P <= 8192, and for K4 HB heads a block for HB in {1, 2, 4} with HB C P
// <= 8192 (the dkpb and dvpb sums, 64 f32 a thread) and C <= 128 where HB
// > 1 (dqn's 16 x C accumulator besides them).
#define SHAPES_FWD(X)                                                   \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64) X(64, 16) \
  X(64, 32) X(64, 64) X(128, 16) X(128, 32) X(128, 64) X(256, 16)       \
  X(256, 32)
#define SHAPES_BWD(X)                                                  \
  X(16, 16, 1) X(16, 16, 2) X(16, 16, 4) X(16, 32, 1) X(16, 32, 2)     \
  X(16, 32, 4) X(16, 64, 1) X(16, 64, 2) X(16, 64, 4) X(32, 16, 1)     \
  X(32, 16, 2) X(32, 16, 4) X(32, 32, 1) X(32, 32, 2) X(32, 32, 4)     \
  X(32, 64, 1) X(32, 64, 2) X(32, 64, 4) X(64, 16, 1) X(64, 16, 2)     \
  X(64, 16, 4) X(64, 32, 1) X(64, 32, 2) X(64, 32, 4) X(64, 64, 1)     \
  X(64, 64, 2) X(128, 16, 1) X(128, 16, 2) X(128, 16, 4) X(128, 32, 1) \
  X(128, 32, 2) X(128, 64, 1) X(256, 16, 1) X(256, 32, 1)

// K3's output columns a warp unit: all C up to 128, else half (two units
// a token tile)
constexpr int fwd_cols(int C) { return C < 128 ? C : 128; }

// the shared-memory cap of one kernel instance, set on its first launch
template <typename K>
cudaError_t allow_smem(K kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  done = e == cudaSuccess;
  return e;
}

Drop dropout(unsigned key, unsigned xbase, unsigned thresh, float inv_keep,
             int drop) {
  Drop d;
  d.key1 = key ^ (key >> 16);
  d.xb = xbase;
  d.thresh = thresh;
  d.inv = drop ? inv_keep : 1.f;
  d.on = drop;
  return d;
}

template <int C, int P, int CO>
int launch_fwd(const FwdParams& p, int blocks, int B, cudaStream_t s) {
  static bool ready = false;
  auto kern = spatial_attn_fwd_kernel<C, P, CO>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = fwd_smem(C, p.HP);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(blocks, B), NT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int P, int HB>
int launch_bwd(const BwdParams& p, const FinishParams& f, int B,
               cudaStream_t s) {
  static bool ready = false;
  auto kern = spatial_attn_bwd_kernel<C, P, HB>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = bwd_smem(C, HB * P, p.T);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(p.chunks, p.HP / (HB * P), B), NT, bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long vecs = (2 * f.n_kv + (f.groups > 0 ? f.n_q : 0)) / 4;
  spatial_attn_bwd_finish<<<(unsigned)((vecs + FT - 1) / FT), FT, 0, s>>>(f);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int P>
int launch_rows(const WideRows<E>& p, int bwd, int B, cudaStream_t s) {
  static bool ready[2] = {false, false};
  auto kern = bwd ? spatial_attn_bwd_kernel_wide<E, P>
                  : spatial_attn_fwd_kernel_wide<E, P>;
  cudaError_t e = allow_smem(kern, ready[bwd]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = wide_rows_smem(sizeof(E), bwd, p.C, p.HP, p.kc, p.kq);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3((p.N + WTOK - 1) / WTOK, B), WT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_rows_p(const WideRows<E>& p, int bwd, int P, int B,
                  cudaStream_t s) {
  switch (P) {
    case 16: return launch_rows<E, 16>(p, bwd, B, s);
    case 32: return launch_rows<E, 32>(p, bwd, B, s);
    case 64: return launch_rows<E, 64>(p, bwd, B, s);
    case 128: return launch_rows<E, 128>(p, bwd, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename E>
int launch_sums(const WideSums<E>& p, const FinishParams& f, int B,
                cudaStream_t s) {
  static bool ready = false;
  auto kern = spatial_attn_bwd_sums_wide<E>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = wide_sums_smem(sizeof(E), p.C, p.HP);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  const int ck = wide_ck(p.C);
  const int tiles = p.HP / imin(p.HP, WSUM_Q) * (ck / imin(ck, WSUM_C));
  kern<<<dim3(tiles, p.chunks, 2 * B), WT, bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long vecs = 2 * f.n_kv / 4;
  spatial_attn_bwd_finish<<<(unsigned)((vecs + FT - 1) / FT), FT, 0, s>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// the wide instances' widths: C a power of two from 8 to 512, P 16 .. 128,
// 1, 2 or 4 heads; kc a power of two from 16 dividing C (padded to 16),
// kq a power of two from 16 dividing hP (kernels/spatial_attn.py::
// wide_plan)
bool wide_ok(int C, int P, int HP, int kc, int kq) {
  const bool c_ok = C >= 8 && C <= 512 && (C & (C - 1)) == 0;
  const bool p_ok = P == 16 || P == 32 || P == 64 || P == 128;
  const int h = p_ok ? HP / P : 0;
  return c_ok && p_ok && HP % P == 0 && (h == 1 || h == 2 || h == 4) &&
         kc >= 16 && (kc & (kc - 1)) == 0 && wide_ck(C) % kc == 0 &&
         kq >= 16 && (kq & (kq - 1)) == 0 && HP % kq == 0;
}

}  // namespace

// K3. cols: output columns a warp unit takes (C, or C / 2 at C = 256);
// per_block units (16 tokens x cols) a block walks, blocks per batch item
// (kernels/spatial_attn.py::spatial_attn_plan)
extern "C" int fcd_spatial_attn_fwd(const void* qn, const void* kpb,
                                    const void* vpb, void* out, int B, int N,
                                    int C, int HP, int P, int cols,
                                    int per_block, int blocks, unsigned key,
                                    unsigned xbase, unsigned thresh,
                                    float inv_keep, int drop,
                                    void* stream) {
  if (N < 1 || B < 1 || P < 1 || HP % P || per_block < 1 || blocks < 1 ||
      cols < 1 || C % cols ||
      (long long)blocks * per_block < (long long)((N + 15) / 16) * (C / cols))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.qn = static_cast<const h16*>(qn);
  p.kpb = static_cast<const h16*>(kpb);
  p.vpb = static_cast<const h16*>(vpb);
  p.out = static_cast<h16*>(out);
  p.N = N;
  p.HP = HP;
  p.units = (N + 15) / 16 * (C / cols);
  p.per_block = per_block;
  p.d = dropout(key, xbase, thresh, inv_keep, drop);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C * 1000 + P * 10 + C / cols) {
#define FWD_CASE(C, P)                                      \
  case C * 1000 + P * 10 + C / fwd_cols(C):                 \
    return launch_fwd<C, P, fwd_cols(C)>(p, blocks, B, s);
    SHAPES_FWD(FWD_CASE)
#undef FWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4 and its finishing pass. hb heads a block, t tokens a step, chunks of
// the ceil(N / t) tiles (kernels/spatial_attn.py::spatial_attn_plan).
// Scratch: dk_part and dv_part (chunks, B, C, HP) f32 each; dq_part (HP /
// (hb P), B, N, C) f32 unless one block owns every head (then dqn is
// written by the product kernel and dq_part is not read). dk and dv: f32,
// or h16 where dk_h16 / dv_h16.
extern "C" int fcd_spatial_attn_bwd(
    const void* qn, const void* kpb, const void* vpb, const void* g,
    void* dqn, float* dq_part, float* dk_part, float* dv_part, void* dk,
    void* dv, int dk_h16, int dv_h16, int B, int N, int C, int HP, int P,
    int hb, int t, int chunks, unsigned key, unsigned xbase, unsigned thresh,
    float inv_keep, int drop, void* stream) {
  const int tiles = t > 0 ? (N + t - 1) / t : 0;
  if (N < 1 || B < 1 || P < 1 || hb < 1 || HP % (hb * P) || t < 16 ||
      t % 16 || t > MAX_TILE || chunks < 1 || chunks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool whole = hb > 1 && hb * P == HP;
  if (!whole && dq_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.qn = static_cast<const h16*>(qn);
  p.kpb = static_cast<const h16*>(kpb);
  p.vpb = static_cast<const h16*>(vpb);
  p.g = static_cast<const h16*>(g);
  p.dqn = whole ? static_cast<h16*>(dqn) : nullptr;
  p.dq_part = dq_part;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.N = N;
  p.HP = HP;
  p.T = t;
  p.tiles = tiles;
  p.chunks = chunks;
  p.d = dropout(key, xbase, thresh, inv_keep, drop);
  FinishParams f;
  f.dk_part = dk_part;
  f.dv_part = dv_part;
  f.dq_part = dq_part;
  f.dk = dk;
  f.dv = dv;
  f.dqn = dqn;
  f.chunks = chunks;
  f.groups = whole ? 0 : HP / (hb * P);
  f.n_kv = (long long)B * C * HP;
  f.n_q = (long long)B * N * C;
  f.dk_h16 = dk_h16;
  f.dv_h16 = dv_h16;
  f.dq_h16 = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C * 1000 + P * 10 + hb) {
#define BWD_CASE(C, P, HB) \
  case C * 1000 + P * 10 + HB: return launch_bwd<C, P, HB>(p, f, B, s);
    SHAPES_BWD(BWD_CASE)
#undef BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

template <typename E>
int fwd_wide(const void* qn, const void* kpb, const void* vpb, void* out,
             int B, int N, int C, int HP, int P, int kc, int kq,
             unsigned key, unsigned xbase, unsigned thresh, float inv_keep,
             int drop, cudaStream_t stream) {
  if (N < 1 || B < 1 || !wide_ok(C, P, HP, kc, kq))
    return static_cast<int>(cudaErrorInvalidValue);
  WideRows<E> p;
  p.qn = static_cast<const E*>(qn);
  p.kpb = static_cast<const E*>(kpb);
  p.vpb = static_cast<const E*>(vpb);
  p.g = nullptr;
  p.out = static_cast<E*>(out);
  p.a = p.ds = nullptr;
  p.N = N;
  p.C = C;
  p.HP = HP;
  p.kc = kc;
  p.kq = kq;
  p.d = dropout(key, xbase, thresh, inv_keep, drop);
  return launch_rows_p(p, 0, P, B, stream);
}

template <typename E>
int bwd_wide(const void* qn, const void* kpb, const void* vpb, const void* g,
             void* dqn, void* a, void* ds, float* dk_part, float* dv_part,
             void* dk, void* dv, int dk_h16, int dv_h16, int B, int N, int C,
             int HP, int P, int kc, int kq, int chunks, unsigned key,
             unsigned xbase, unsigned thresh, float inv_keep, int drop,
             cudaStream_t stream) {
  const int tiles = (N + WSUM_T - 1) / WSUM_T;
  if (N < 1 || B < 1 || !wide_ok(C, P, HP, kc, kq) || chunks < 1 ||
      chunks > tiles || a == nullptr || ds == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  WideRows<E> p;
  p.qn = static_cast<const E*>(qn);
  p.kpb = static_cast<const E*>(kpb);
  p.vpb = static_cast<const E*>(vpb);
  p.g = static_cast<const E*>(g);
  p.out = static_cast<E*>(dqn);
  p.a = static_cast<E*>(a);
  p.ds = static_cast<E*>(ds);
  p.N = N;
  p.C = C;
  p.HP = HP;
  p.kc = kc;
  p.kq = kq;
  p.d = dropout(key, xbase, thresh, inv_keep, drop);
  int err = launch_rows_p(p, 1, P, B, stream);
  if (err != 0) return err;
  WideSums<E> q;
  q.a = p.a;
  q.ds = p.ds;
  q.qn = p.qn;
  q.g = p.g;
  q.dk_part = dk_part;
  q.dv_part = dv_part;
  q.N = N;
  q.C = C;
  q.HP = HP;
  q.tiles = tiles;
  q.chunks = chunks;
  FinishParams f;
  f.dk_part = dk_part;
  f.dv_part = dv_part;
  f.dq_part = nullptr;
  f.dk = dk;
  f.dv = dv;
  f.dqn = nullptr;
  f.chunks = chunks;
  f.groups = 0;
  f.n_kv = (long long)B * C * HP;
  f.n_q = 0;
  f.dk_h16 = dk_h16;
  f.dv_h16 = dv_h16;
  f.dq_h16 = 0;
  return launch_sums(q, f, B, stream);
}

}  // namespace

// K3, the wide instances (C15) and, with f32 = 1, the f32 instances (C18,
// in the h16 = bf16 library only): row blocks of 32 tokens, grid (ceil(N /
// 32), B), kpb's rows kc at a time and vpb's rows kq at a time
// (kernels/spatial_attn.py::wide_plan); qn, kpb, vpb and out h16, or f32
// with f32 = 1
extern "C" int fcd_spatial_attn_fwd_wide(const void* qn, const void* kpb,
                                         const void* vpb, void* out, int B,
                                         int N, int C, int HP, int P, int kc,
                                         int kq, int f32, unsigned key,
                                         unsigned xbase, unsigned thresh,
                                         float inv_keep, int drop,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifndef FCD_F16
  if (f32)
    return fwd_wide<float>(qn, kpb, vpb, out, B, N, C, HP, P, kc, kq, key,
                           xbase, thresh, inv_keep, drop, s);
#else
  if (f32) return static_cast<int>(cudaErrorInvalidValue);
#endif
  return fwd_wide<h16>(qn, kpb, vpb, out, B, N, C, HP, P, kc, kq, key,
                       xbase, thresh, inv_keep, drop, s);
}

// K4, the wide and (f32 = 1) the f32 instances: the row blocks (dqn, and
// a and ds into the scratch), the token sums (chunks of the ceil(N / 64)
// 64-token steps, one f32 partial of dkpb and dvpb a chunk) and the
// finishing pass, three launches. Scratch: a, ds (B, N, HP) in the
// operands' type; dk_part, dv_part (chunks, B, C, HP) f32. dk and dv: f32,
// or h16 where dk_h16 / dv_h16; dqn in the operands' type.
extern "C" int fcd_spatial_attn_bwd_wide(
    const void* qn, const void* kpb, const void* vpb, const void* g,
    void* dqn, void* a, void* ds, float* dk_part, float* dv_part, void* dk,
    void* dv, int dk_h16, int dv_h16, int B, int N, int C, int HP, int P,
    int kc, int kq, int chunks, int f32, unsigned key, unsigned xbase,
    unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifndef FCD_F16
  if (f32)
    return bwd_wide<float>(qn, kpb, vpb, g, dqn, a, ds, dk_part, dv_part, dk,
                           dv, dk_h16, dv_h16, B, N, C, HP, P, kc, kq, chunks,
                           key, xbase, thresh, inv_keep, drop, s);
#else
  if (f32) return static_cast<int>(cudaErrorInvalidValue);
#endif
  return bwd_wide<h16>(qn, kpb, vpb, g, dqn, a, ds, dk_part, dv_part, dk, dv,
                       dk_h16, dv_h16, B, N, C, HP, P, kc, kq, chunks, key,
                       xbase, thresh, inv_keep, drop, s);
}
