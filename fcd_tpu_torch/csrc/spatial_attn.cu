// K3 / K4: the train spatial-attention tail of the DSA block, forward and
// backward, on the tensor cores (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas (K3,
// pallas_call :166) and spatial_attn_bwd_pallas (K4, pallas_call :190).
// With qn (B, N, C) the l2-normalised queries, kpb (B, C, hP) the
// block-expanded keys (temperature folded in) and vpb (B, hP, C) the
// block-expanded values, all bf16, h heads of P columns (hP = h * P):
//
//   s[n, :]  = softmax over each head's P-wide segment of (qn[n] . kpb)   (f32)
//   a        = bf16(keep ? s / (1 - rate) : 0)
//   out[n]   = bf16(a[n] . vpb)                                          (K3)
//
// K4 recomputes s and the mask and gives, with g the cotangent of out:
//   dvpb = a^T g,   da = keep ? (g . vpb^T) / (1 - rate) : 0,
//   ds   = bf16(s * (da - sum_segment(da * s))),
//   dqn  = bf16(ds . kpb^T),   dkpb = qn^T ds                 (f32 sums)
// kpb and vpb are taken as general matrices (no block-diagonal zeros are
// assumed). The rounding points are the TPU kernel's: f32 logits, s, da
// and sums; bf16 a, out, ds and dqn; ds takes the pre-dropout s.
//
// Dropout: keep iff fmix32(idx * 0x9E3779B1 ^ key) >= rate * 2^32, where
// idx = (b * N + n) * hP + column (mod 2^32) and key mixes the step's seed
// with the layer's salt. It is a counter-based hash, so K4 regenerates K3's
// mask exactly, and kernels/spatial_attn.py computes the same bits with
// int64 torch ops for the plain version.
//
// What bounds them (H100: 989 TFLOP/s bf16, 3.35 TB/s): per token K3 does
// 4 C hP operations on 4 C bytes (qn in, out back), K4 10 C hP on 6 C:
// at hP = 256, 256 and 427 operations a byte, at the card's balance point
// (~295). At level 3 (B = 4, N = 32768, C = 32) the bound is 5 us (K3,
// bytes) and 11 us (K4, operations). Beside the products each element of
// the B x N x hP attention tile (34 M at level 3) costs an exp on the SFU
// and the dropout hash, ~10 integer operations (keep_x), on the CUDA
// cores; that elementwise work, not the tensor cores, is what bounds these
// kernels in practice (kernels/spattn_sweep.py times them at rate 0 and
// 0.1). The design:
//   * Every product is mma.sync m16n8k16 (bf16 operands from ldmatrix, f32
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
//     a and ds go to shared memory in bf16 and come back by
//     ldmatrix.trans as the A^T operands of the token-contracted sums
//     dvpb += a^T g and dkpb += qn^T ds, whose C x HB*P tiles stay in
//     registers over the chunk, split over the block's eight warps (at
//     most 64 f32 a thread; a sum of fewer than 16 m16n8 tiles goes to the
//     first warps, a pair each). HB <= 8192 / (C P) heads fit that (level
//     3: all four, the whole row; level 4: two; levels 5-6: one, a split
//     by head). dqn sums over every head, so a block that owns all of them
//     stores it in bf16, and otherwise writes one f32 partial per head
//     group.
//   * Widths: C a power of two from 16 to 256, P 16, 32 or 64, C P <= 8192
//     (SHAPES_FWD / SHAPES_BWD below): the default model's levels and the
//     narrower ones of smaller feature and projection sizes. Every other
//     (C, P) that B5 takes (C 8 .. 512, P 16 .. 128: segresnet_deeper's
//     (256, 64), MS_DSA_NET's fs32 and project-128 levels) runs the wide
//     instances at the end of this file (C15): CUDA-core kernels that read
//     kpb and vpb from L2 and split each head's columns over blocks, so
//     that their sums fit; correct first, with their times in PERF.md.
//     Instanced on f32 operands, the same kernels are K3/K4 in f32 at
//     every one of B5's (C, P) (C18: a model that computes in f32).
//   * No atomics: each chunk writes one f32 partial of dkpb and dvpb, and
//     spatial_attn_bwd_finish adds the chunks' partials (and the head
//     groups' dqn partials) in a fixed order, writing dkpb and dvpb in
//     the dtype the caller asks for (f32 or bf16) and dqn in bf16. Two
//     calls give the same bits; one K4 call is two launches.
//   * Tiles, chunks and head groups come from kernels/spatial_attn.py::
//     spatial_attn_plan (pure Python); the launchers take its numbers.
//     kernels/spattn_sweep.py --plans times the alternatives on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;            // threads of a product block
constexpr int NW = NT / 32;
constexpr int FT = 256;            // threads of a finishing-pass block
constexpr int SMEM_CAP = 232448;   // shared memory one block may hold
constexpr int MAX_TILE = 16 * NW;  // K4 tokens a step: one m-tile a warp
constexpr float LOG2E = 1.4426950408889634f;

// a bf16 row pitch of at least n elements: a multiple of 8 elements that
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

// rows x cols bf16 (cols % 8 == 0) from src (row stride ld elements) into
// shared dst (pitch dp) by cp.async, rows >= valid zero-filled
__device__ void stage(const bf16* src, int ld, int rows, int valid, int cols,
                      bf16* dst, int dp) {
  const int vr = cols / 8;
  for (int v = threadIdx.x; v < rows * vr; v += blockDim.x) {
    const int r = v / vr, c = (v - r * vr) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * dp + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

struct Drop {
  uint32_t key1;    // key ^ (key >> 16), see keep_x
  uint32_t thresh;
  float inv;        // 1 / (1 - rate); 1 without dropout
  int on;
};

constexpr uint32_t K0 = 0x9E3779B1u;  // the hash's index multiplier

// keep iff fmix32(x ^ key) >= thresh, x = idx * K0. fmix32's first
// xor-shift of x ^ key is x ^ (x >> 16) ^ key1 (a shift distributes over
// xor), so the key costs no operation of its own.
__device__ __forceinline__ bool keep_x(uint32_t x, const Drop& d) {
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
// over the row sums of rows g and g + 8 (f32)
template <int P>
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
    s[j][0] = ex2(fmaf(s[j][0], LOG2E, -m0));
    s[j][1] = ex2(fmaf(s[j][1], LOG2E, -m0));
    s[j][2] = ex2(fmaf(s[j][2], LOG2E, -m1));
    s[j][3] = ex2(fmaf(s[j][3], LOG2E, -m1));
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
__device__ __forceinline__ void logits(float (&s)[P / 8][4], const bf16* A,
                                       int ap, const bf16* Bs, int bp,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * ap + kk * 16 + (lane >> 4) * 8);
    const bf16* brow = Bs + (kk * 16 + (lane & 15)) * bp + (lane >> 4) * 8;
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
// in bf16
template <int P>
__device__ __forceinline__ void store_frags(bf16* D, int dp, int r0, int q0,
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
  const bf16* qn;   // (B, N, C)
  const bf16* kpb;  // (B, C, HP)
  const bf16* vpb;  // (B, HP, C)
  bf16* out;        // (B, N, C)
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
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // C x kp: kpb[b]
  bf16* Vs = Ks + C * kp;                        // HP x CP: vpb[b]
  bf16* Qw = Vs + HP * CP + warp * 16 * CP;      // this warp's 16 tokens
  stage(p.kpb + (size_t)b * C * HP, HP, C, C, HP, Ks, kp);
  stage(p.vpb + (size_t)b * HP * C, C, HP, HP, C, Vs, CP);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int u_end = min((blockIdx.x + 1) * p.per_block, p.units);
  for (int u = blockIdx.x * p.per_block + warp; u < u_end; u += NW) {
    const int n0 = (u / GROUPS) * 16, c0 = (u % GROUPS) * CO;
    const bf16* qb = p.qn + ((size_t)b * p.N + n0) * C;
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
      // o += bf16(a) . vpb[hh*P .., c0 ..] (B by ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t a[4];
        frag_a<P>(a, s, kk);
        const bf16* brow = Vs + (hh * P + kk * 16 + (lane & 15)) * CP + c0 +
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
    // out = bf16(o), staged in the warp's token rows, stored 16 bytes a lane
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
  const bf16* qn;   // (B, N, C)
  const bf16* kpb;  // (B, C, HP)
  const bf16* vpb;  // (B, HP, C)
  const bf16* g;    // (B, N, C) cotangent of out
  bf16* dqn;        // (B, N, C), when a block owns every head
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
                                          const bf16* A, int ap, const bf16* B,
                                          int bp, int t0, int m_base,
                                          int n_base, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t a[4];
    ldsm_x4_t(a, A + (t0 + (lane & 7) + ((lane >> 4) << 3)) * ap +
                     (m_base + r) * 16 + ((lane >> 3) & 1) * 8);
    const bf16* brow = B + (t0 + (lane & 15)) * bp + (lane >> 4) * 8;
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
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // C x BP: kpb[b][:, q0 ..]
  bf16* Vs = Ks + C * BP;                        // HBP x CP: vpb[b][q0 .., :]
  bf16* QG = Vs + HBP * CP;  // two stages of (qn | g) tiles, T x CP each
  bf16* As = QG + 4 * T * CP;                    // T x BP: a
  bf16* Ds = As + T * BP;                        // T x BP: ds

  const int t_begin = chunk * p.tiles / p.chunks;
  const int t_end = (chunk + 1) * p.tiles / p.chunks;
  auto load_tile = [&](int tile, int stg) {
    const int n0 = tile * T;
    const size_t off = ((size_t)b * N + n0) * C;
    bf16* q = QG + stg * 2 * T * CP;
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
    const bf16* Qs = QG + stg * 2 * T * CP;
    const bf16* Gs = Qs + T * CP;

    // per warp 16 tokens: logits, s, mask, a, da, ds, dqn
    for (int mt = warp; mt < T / 16; mt += NW) {
      const bf16* Qw = Qs + mt * 16 * CP;
      const bf16* Gw = Gs + mt * 16 * CP;
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
        {  // a = bf16(keep ? s * inv : 0), to As
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
        // ds = bf16(s * (da - sum_row(da * s))), da masked and scaled
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
  void* dk;              // n_kv, f32 or bf16
  void* dv;
  void* dqn;             // n_q, bf16 (the f32 instances: f32)
  int chunks, groups;
  long long n_kv, n_q;   // elements, multiples of 4
  int dk_bf16, dv_bf16, dq_bf16;
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

__device__ __forceinline__ void store4(void* dst, int is_bf16, long long i,
                                       float4 v) {
  if (is_bf16)
    *reinterpret_cast<uint2*>(static_cast<bf16*>(dst) + i) =
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
    store4(p.dk, p.dk_bf16, 4 * v, ordered_sum(p.dk_part, 4 * v, p.chunks,
                                               p.n_kv));
  } else if (v < 2 * kv4) {
    const long long i = 4 * (v - kv4);
    store4(p.dv, p.dv_bf16, i, ordered_sum(p.dv_part, i, p.chunks, p.n_kv));
  } else if (p.groups > 0 && v < 2 * kv4 + p.n_q / 4) {
    const long long i = 4 * (v - 2 * kv4);
    store4(p.dqn, p.dq_bf16, i, ordered_sum(p.dq_part, i, p.groups, p.n_q));
  }
}

// ---- the wide instances (C15), and the f32 instances (C18) -------------
//
// Every (C, P) with C a power of two from 8 to 512 and P 16 .. 128 that the
// tensor-core instances above do not take (C = 8, C = 512, P = 128, and C P
// > 8192: SHAPES_WIDE in kernels/spatial_attn.py). There a block's dkpb
// and dvpb sums (C x P f32 each) do not fit its registers, and at (512,
// 128) a head's kpb columns and vpb rows (128 KB each in bf16) not its
// shared memory beside each other. These kernels take a simpler road, on
// the CUDA cores in f32: a block holds a tile of TOK tokens (TOK C <= 8192)
// and, one operand at a time, a head's C x P of kpb or vpb in shared
// memory, staged from L2 with 16-byte loads; K4 splits each head's P
// columns over S = C P / 8192 blocks (1, 2, 4 or 8), each recomputing the
// head's softmax row and owning the dkpb and dvpb sums of its P / S
// columns (at most 32 f32 a thread each) and the dqn partial of those
// columns. Same math, rounding points, dropout bits and fixed-order
// finishing pass as the tensor-core instances; no atomics.
//
// The same kernels, templated on the operand type E, are the f32
// instances (ROADMAP C18) of every (C, P) B5 takes: a model that computes
// in f32 runs the JAX package's spatial_attn_train in f32, where every
// bf16 rounding point (a, ds, out, dqn) is a no-op
// (fcd_tpu/kernels/spatial_attn.py:83,113,131). With E = float the tiles
// and the staged operand are f32, round_to is the identity and the stores
// write f32; every product is an f32 fused multiply-add on the CUDA cores
// (no tensor-core instruction, so no TF32). A head's C x P operand in f32
// can outgrow shared memory (512 x 130 x 4 bytes), so the operand is
// staged PB columns at a time (PB divides P; kernels/spatial_attn.py::
// wide_plan picks it): each logit and each output element is still one
// sum over the same terms in the same order, so a smaller PB gives the
// same bits. The bf16 instances take PB = P.

constexpr int WT = 256;        // threads of a wide block
constexpr int WACC = 32;       // sums a thread: 8192 / WT
constexpr int WIDE_SUMS = WT * WACC;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// the value as the operand type holds it: bf16's rounding, or none
template <typename E>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float wmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// TOK rows of C elements (row stride C) from token n0 of batch item b into
// shared dst (TOK x C), rows past N zero; 16-byte copies
template <typename E>
__device__ void load_rows(const E* src, int b, int N, int C, int n0,
                          int TOK, E* dst) {
  constexpr int V = 16 / sizeof(E);  // elements a 16-byte copy
  const E* s = src + ((size_t)b * N + n0) * C;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int v = threadIdx.x; v < TOK * C / V; v += WT) {
    const int t = v / (C / V);
    reinterpret_cast<uint4*>(dst)[v] =
        n0 + t < N ? reinterpret_cast<const uint4*>(s)[v] : zero;
  }
}

// Ws[c][q] = m[c][q0 + q] (C x P of a row-major matrix of row stride ld),
// 16-byte copies
template <typename E>
__device__ void stage_cols(const E* m, int ld, int q0, int C, int P, E* Ws) {
  constexpr int V = 16 / sizeof(E);
  for (int v = threadIdx.x; v < C * P / V; v += WT) {
    const int c = v / (P / V), q = (v - c * (P / V)) * V;
    *reinterpret_cast<uint4*>(Ws + c * P + q) =
        *reinterpret_cast<const uint4*>(m + (size_t)c * ld + q0 + q);
  }
}

// Ws[c][q] = m[r0 + q][c] (the transpose of P rows of a row-major matrix
// of row stride C) at pitch P + 2, so that threads on consecutive c read
// distinct banks: 16-byte loads along the rows, element stores
template <typename E>
__device__ void stage_rows_t(const E* m, int r0, int C, int P, E* Ws) {
  constexpr int V = 16 / sizeof(E);
  for (int v = threadIdx.x; v < P * C / V; v += WT) {
    const int q = v / (C / V), c = (v - q * (C / V)) * V;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(m + (size_t)(r0 + q) * C + c);
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) Ws[(c + i) * (P + 2) + q] = e[i];
  }
}

// S[t][q] (row stride sp) = sum_c A[t][c] W[c][q] for q < P (A TOK x C, W
// C x P at pitch wp, both in shared memory): consecutive threads take
// consecutive q
template <typename E>
__device__ void tile_product(const E* A, const E* W, int wp, int C, int TOK,
                             int P, float* S, int sp) {
  for (int i = threadIdx.x; i < TOK * P; i += WT) {
    const int t = i / P, q = i - t * P;
    const E* ar = A + t * C;
    float s0 = 0.f, s1 = 0.f;
    for (int c = 0; c < C; c += 2) {
      s0 = fmaf(to_f(ar[c]), to_f(W[c * wp + q]), s0);
      s1 = fmaf(to_f(ar[c + 1]), to_f(W[(c + 1) * wp + q]), s1);
    }
    S[t * sp + q] = s0 + s1;
  }
}

// one softmax row of P logits in place (a warp): returns 1 / sum; srow
// holds exp(s - max)
__device__ __forceinline__ float softmax_row(float* srow, int P, int lane) {
  float mx = -INFINITY;
  for (int q = lane; q < P; q += 32) mx = fmaxf(mx, srow[q]);
  mx = wmax(mx);
  float sum = 0.f;
  for (int q = lane; q < P; q += 32) {
    const float e = expf(srow[q] - mx);
    srow[q] = e;
    sum += e;
  }
  return 1.f / wsum(sum);
}

template <typename E>
struct WideFwd {
  const E* qn;   // (B, N, C)
  const E* kpb;  // (B, C, HP)
  const E* vpb;  // (B, HP, C)
  E* out;        // (B, N, C)
  int N, C, HP, P, TOK, PB;
  Drop d;
};

// qn's tile, PB columns of one head's C x P operand (pitch PB + 2), its
// TOK x P scores
__host__ __device__ constexpr int wide_fwd_smem(int esize, int C, int P,
                                                int TOK, int PB) {
  return esize * TOK * C + esize * C * (PB + 2) + 4 * TOK * P;
}

// grid (token tile, batch): the tile's TOK tokens, head by head
template <typename E>
__global__ void __launch_bounds__(WT)
    spatial_attn_fwd_kernel_wide(const WideFwd<E> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, P = p.P, HP = p.HP, TOK = p.TOK, N = p.N, PB = p.PB;
  E* Qs = reinterpret_cast<E*>(smem_raw);  // TOK x C
  E* Ws = Qs + TOK * C;  // C x PB: kpb (pitch PB), then vpb^T (PB + 2)
  float* Ss = reinterpret_cast<float*>(Ws + C * (PB + 2));  // s, then a
  const int b = blockIdx.y, n0 = blockIdx.x * TOK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const E* kb = p.kpb + (size_t)b * C * HP;
  const E* vb = p.vpb + (size_t)b * HP * C;
  load_rows(p.qn, b, N, C, n0, TOK, Qs);
  float acc[WACC];
#pragma unroll
  for (int j = 0; j < WACC; ++j) acc[j] = 0.f;
  for (int hh = 0; hh < HP / P; ++hh) {
    for (int qb = 0; qb < P; qb += PB) {
      __syncthreads();  // the last products are done with Ws and Ss
      stage_cols(kb, HP, hh * P + qb, C, PB, Ws);
      __syncthreads();
      tile_product(Qs, Ws, PB, C, TOK, PB, Ss + qb, P);  // logits
    }
    __syncthreads();
    // a = round(keep ? softmax(s) / (1 - rate) : 0), a warp a token
    for (int t = warp; t < TOK; t += WT / 32) {
      float* row = Ss + t * P;
      const float inv = softmax_row(row, P, lane);
      const uint32_t x = elem_x(b, N, HP, n0 + t, hh * P);
      for (int q = lane; q < P; q += 32) {
        const float a = row[q] * inv;
        row[q] = round_to<E>(!p.d.on || keep_x(x + (uint32_t)q * K0, p.d)
                                 ? a * p.d.inv
                                 : 0.f);
      }
    }
    // out[t][c] += sum_q a[t][q] vpb[hh P + q][c], Ws[c][q] = vpb[hh P +
    // qb + q][c] a block of PB columns at a time: element j of this thread
    // is e = tid + WT j (consecutive threads, consecutive c)
    for (int qb = 0; qb < P; qb += PB) {
      __syncthreads();  // a is written; the last block is done with Ws
      stage_rows_t(vb, hh * P + qb, C, PB, Ws);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < WACC; ++j) {
        const int e = threadIdx.x + WT * j;
        if (e >= TOK * C) break;
        const int t = e / C, c = e - t * C;
        const float* ar = Ss + t * P + qb;
        const E* wc = Ws + c * (PB + 2);
        float s = acc[j];
        for (int q = 0; q < PB; ++q) s = fmaf(ar[q], to_f(wc[q]), s);
        acc[j] = s;
      }
    }
  }
  E* ob = p.out + ((size_t)b * N + n0) * C;
#pragma unroll
  for (int j = 0; j < WACC; ++j) {
    const int e = threadIdx.x + WT * j;
    if (e >= TOK * C) break;
    if (n0 + e / C < N) ob[e] = from_f<E>(acc[j]);
  }
}

template <typename E>
struct WideBwd {
  const E* qn;   // (B, N, C)
  const E* kpb;  // (B, C, HP)
  const E* vpb;  // (B, HP, C)
  const E* g;    // (B, N, C)
  float* dq_part;   // (HP / P * S, B, N, C): one per (head, split)
  float* dk_part;   // (chunks, B, C, HP)
  float* dv_part;   // (chunks, B, HP, C)
  int N, C, HP, P, TOK, tiles, chunks, S, PB;
  Drop d;
};

// the qn and g tiles, PB columns of one head's C x P operand (pitch PB +
// 2), s and da / ds (TOK x P f32), a on the split's CS columns, and the
// split's kpb columns (C x (CS + 2): pitches off the banks' period)
__host__ __device__ constexpr int wide_bwd_smem(int esize, int C, int P,
                                                int TOK, int S, int PB) {
  return 2 * esize * TOK * C + esize * C * (PB + 2) + 8 * TOK * P +
         4 * TOK * (P / S) + esize * C * (P / S + 2);
}

// grid (chunk, head x split, batch)
template <typename E>
__global__ void __launch_bounds__(WT)
    spatial_attn_bwd_kernel_wide(const WideBwd<E> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, P = p.P, HP = p.HP, TOK = p.TOK, N = p.N, S = p.S;
  const int PB = p.PB;
  const int CS = P / S, KP = CS + 2;  // the split's columns, Ks's pitch
  const int chunk = blockIdx.x, hs = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int q0 = (hs / S) * P;       // the head's first column
  const int qs = (hs % S) * CS;      // the split's first column in the head
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  E* Qs = reinterpret_cast<E*>(smem_raw);        // TOK x C
  E* Gs = Qs + TOK * C;                          // TOK x C
  E* Ws = Gs + TOK * C;  // C x PB: kpb (pitch PB), then vpb^T (PB + 2)
  float* Ss = reinterpret_cast<float*>(Ws + C * (PB + 2));  // TOK x P: s
  float* Ds = Ss + TOK * P;                      // TOK x P: da, then ds
  float* As = Ds + TOK * P;                      // TOK x CS: a
  E* Ks = reinterpret_cast<E*>(As + TOK * CS);   // C x KP
  const E* kb = p.kpb + (size_t)b * C * HP;
  const E* vb = p.vpb + (size_t)b * HP * C;
  for (int i = threadIdx.x; i < C * CS; i += WT) {
    const int c = i / CS, q = i - c * CS;
    Ks[c * KP + q] = kb[(size_t)c * HP + q0 + qs + q];
  }
  float dk[WACC], dv[WACC];  // dkpb (C x CS) and dvpb (CS x C) elements
#pragma unroll
  for (int j = 0; j < WACC; ++j) dk[j] = dv[j] = 0.f;
  const int t_begin = chunk * p.tiles / p.chunks;
  const int t_end = (chunk + 1) * p.tiles / p.chunks;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * TOK;
    __syncthreads();  // the last tile's sums are done
    load_rows(p.qn, b, N, C, n0, TOK, Qs);
    load_rows(p.g, b, N, C, n0, TOK, Gs);
    for (int qb = 0; qb < P; qb += PB) {
      if (qb > 0) __syncthreads();  // the last block's products are done
      stage_cols(kb, HP, q0 + qb, C, PB, Ws);
      __syncthreads();
      tile_product(Qs, Ws, PB, C, TOK, PB, Ss + qb, P);  // logits
    }
    __syncthreads();
    for (int qb = 0; qb < P; qb += PB) {
      stage_rows_t(vb, q0 + qb, C, PB, Ws);  // Ws[c][q] = vpb[q0 + qb + q][c]
      __syncthreads();
      tile_product(Gs, Ws, PB + 2, C, TOK, PB, Ds + qb, P);  // da = g . vpb^T
      __syncthreads();
    }
    // per token (a warp each): s, the mask, a on the split's columns,
    // ds = round(s (da' - sum(da' s))) with da' = keep ? da / (1 - rate) : 0
    for (int t = warp; t < TOK; t += WT / 32) {
      float* srow = Ss + t * P;
      float* drow = Ds + t * P;
      const float inv = softmax_row(srow, P, lane);
      const uint32_t x = elem_x(b, N, HP, n0 + t, q0);
      float dot = 0.f;
      for (int q = lane; q < P; q += 32) {
        const float s = srow[q] * inv;
        const bool keep = !p.d.on || keep_x(x + (uint32_t)q * K0, p.d);
        const float da = keep ? drow[q] * p.d.inv : 0.f;
        srow[q] = s;
        drow[q] = da;
        dot = fmaf(da, s, dot);
        if (q >= qs && q < qs + CS)
          As[t * CS + q - qs] = round_to<E>(keep ? s * p.d.inv : 0.f);
      }
      dot = wsum(dot);
      for (int q = lane; q < P; q += 32)
        drow[q] = round_to<E>(srow[q] * (drow[q] - dot));
    }
    __syncthreads();
    // dqn's partial of the split: dq[t][c] = sum_q ds[t][qs + q] kpb[c][q0 +
    // qs + q]
    float* dq = p.dq_part + (((size_t)hs * B + b) * N + n0) * C;
    for (int e = threadIdx.x; e < TOK * C; e += WT) {
      const int t = e / C, c = e - t * C;
      if (n0 + t >= N) continue;
      const float* dr = Ds + t * P + qs;
      const E* kr = Ks + c * KP;
      float s = 0.f;
      for (int q = 0; q < CS; ++q) s = fmaf(dr[q], to_f(kr[q]), s);
      dq[e] = s;
    }
    // dkpb[c][q] += sum_t qn[t][c] ds[t][qs + q], dvpb[q][c] += sum_t
    // a[t][q] g[t][c] (tokens past N are zero rows of Qs and Gs)
#pragma unroll
    for (int j = 0; j < WACC; ++j) {
      const int e = threadIdx.x + WT * j;
      if (e >= C * CS) break;
      const int c = e / CS, q = e - c * CS;
      float s = dk[j];
      for (int t = 0; t < TOK; ++t)
        s = fmaf(to_f(Qs[t * C + c]), Ds[t * P + qs + q], s);
      dk[j] = s;
      const int qv = e / C, cv = e - qv * C;
      float v = dv[j];
      for (int t = 0; t < TOK; ++t)
        v = fmaf(As[t * CS + qv], to_f(Gs[t * C + cv]), v);
      dv[j] = v;
    }
  }
  // this chunk's partials of the split's columns
  const size_t slot = (size_t)chunk * B + b;
#pragma unroll
  for (int j = 0; j < WACC; ++j) {
    const int e = threadIdx.x + WT * j;
    if (e >= C * CS) break;
    const int c = e / CS, q = e - c * CS;
    p.dk_part[(slot * C + c) * HP + q0 + qs + q] = dk[j];
    const int qv = e / C, cv = e - qv * C;
    p.dv_part[(slot * HP + q0 + qs + qv) * C + cv] = dv[j];
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

Drop dropout(unsigned key, unsigned thresh, float inv_keep, int drop) {
  Drop d;
  d.key1 = key ^ (key >> 16);
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

template <typename E>
int launch_fwd_wide(const WideFwd<E>& p, int B, cudaStream_t s) {
  static bool ready = false;
  auto kern = spatial_attn_fwd_kernel_wide<E>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = wide_fwd_smem(sizeof(E), p.C, p.P, p.TOK, p.PB);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3((p.N + p.TOK - 1) / p.TOK, B), WT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_bwd_wide(const WideBwd<E>& p, const FinishParams& f, int B,
                    cudaStream_t s) {
  static bool ready = false;
  auto kern = spatial_attn_bwd_kernel_wide<E>;
  cudaError_t e = allow_smem(kern, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = wide_bwd_smem(sizeof(E), p.C, p.P, p.TOK, p.S, p.PB);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(p.chunks, p.HP / p.P * p.S, B), WT, bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long vecs = (2 * f.n_kv + f.n_q) / 4;
  spatial_attn_bwd_finish<<<(unsigned)((vecs + FT - 1) / FT), FT, 0, s>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// the widths of the wide instances: C a power of two from 8 to 512, P
// 16 .. 128, TOK C <= 8192 with TOK a multiple of 16 and at most 64,
// C P / S <= 8192, and PB columns staged at a time, a divisor of P and a
// multiple of 8 (kernels/spatial_attn.py::wide_plan)
bool wide_ok(int C, int P, int HP, int TOK, int S, int PB) {
  const bool c_ok = C >= 8 && C <= 512 && (C & (C - 1)) == 0;
  const bool p_ok = P == 16 || P == 32 || P == 64 || P == 128;
  return c_ok && p_ok && HP % P == 0 && TOK >= 16 && TOK <= 64 &&
         TOK % 16 == 0 && TOK * C <= WIDE_SUMS && S >= 1 && P % S == 0 &&
         (P / S) % 16 == 0 && C * (P / S) <= WIDE_SUMS && PB >= 8 &&
         PB % 8 == 0 && P % PB == 0;
}

}  // namespace

// K3. cols: output columns a warp unit takes (C, or C / 2 at C = 256);
// per_block units (16 tokens x cols) a block walks, blocks per batch item
// (kernels/spatial_attn.py::spatial_attn_plan)
extern "C" int fcd_spatial_attn_fwd(const void* qn, const void* kpb,
                                    const void* vpb, void* out, int B, int N,
                                    int C, int HP, int P, int cols,
                                    int per_block, int blocks, unsigned key,
                                    unsigned thresh, float inv_keep, int drop,
                                    void* stream) {
  if (N < 1 || B < 1 || P < 1 || HP % P || per_block < 1 || blocks < 1 ||
      cols < 1 || C % cols ||
      (long long)blocks * per_block < (long long)((N + 15) / 16) * (C / cols))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.qn = static_cast<const bf16*>(qn);
  p.kpb = static_cast<const bf16*>(kpb);
  p.vpb = static_cast<const bf16*>(vpb);
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.HP = HP;
  p.units = (N + 15) / 16 * (C / cols);
  p.per_block = per_block;
  p.d = dropout(key, thresh, inv_keep, drop);
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
// or bf16 where dk_bf16 / dv_bf16.
extern "C" int fcd_spatial_attn_bwd(
    const void* qn, const void* kpb, const void* vpb, const void* g,
    void* dqn, float* dq_part, float* dk_part, float* dv_part, void* dk,
    void* dv, int dk_bf16, int dv_bf16, int B, int N, int C, int HP, int P,
    int hb, int t, int chunks, unsigned key, unsigned thresh, float inv_keep,
    int drop, void* stream) {
  const int tiles = t > 0 ? (N + t - 1) / t : 0;
  if (N < 1 || B < 1 || P < 1 || hb < 1 || HP % (hb * P) || t < 16 ||
      t % 16 || t > MAX_TILE || chunks < 1 || chunks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool whole = hb > 1 && hb * P == HP;
  if (!whole && dq_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.qn = static_cast<const bf16*>(qn);
  p.kpb = static_cast<const bf16*>(kpb);
  p.vpb = static_cast<const bf16*>(vpb);
  p.g = static_cast<const bf16*>(g);
  p.dqn = whole ? static_cast<bf16*>(dqn) : nullptr;
  p.dq_part = dq_part;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.N = N;
  p.HP = HP;
  p.T = t;
  p.tiles = tiles;
  p.chunks = chunks;
  p.d = dropout(key, thresh, inv_keep, drop);
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
  f.dk_bf16 = dk_bf16;
  f.dv_bf16 = dv_bf16;
  f.dq_bf16 = 1;
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
             int B, int N, int C, int HP, int P, int tok, int pb,
             unsigned key, unsigned thresh, float inv_keep, int drop,
             cudaStream_t stream) {
  if (N < 1 || B < 1 || C < 1 ||
      !wide_ok(C, P, HP, tok, C * P > WIDE_SUMS ? C * P / WIDE_SUMS : 1, pb))
    return static_cast<int>(cudaErrorInvalidValue);
  WideFwd<E> p;
  p.qn = static_cast<const E*>(qn);
  p.kpb = static_cast<const E*>(kpb);
  p.vpb = static_cast<const E*>(vpb);
  p.out = static_cast<E*>(out);
  p.N = N;
  p.C = C;
  p.HP = HP;
  p.P = P;
  p.TOK = tok;
  p.PB = pb;
  p.d = dropout(key, thresh, inv_keep, drop);
  return launch_fwd_wide(p, B, stream);
}

template <typename E>
int bwd_wide(const void* qn, const void* kpb, const void* vpb, const void* g,
             void* dqn, float* dq_part, float* dk_part, float* dv_part,
             void* dk, void* dv, int dk_bf16, int dv_bf16, int B, int N,
             int C, int HP, int P, int tok, int chunks, int split, int pb,
             unsigned key, unsigned thresh, float inv_keep, int drop,
             cudaStream_t stream) {
  const int tiles = tok > 0 ? (N + tok - 1) / tok : 0;
  if (N < 1 || B < 1 || !wide_ok(C, P, HP, tok, split, pb) || chunks < 1 ||
      chunks > tiles || dq_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  WideBwd<E> p;
  p.qn = static_cast<const E*>(qn);
  p.kpb = static_cast<const E*>(kpb);
  p.vpb = static_cast<const E*>(vpb);
  p.g = static_cast<const E*>(g);
  p.dq_part = dq_part;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.N = N;
  p.C = C;
  p.HP = HP;
  p.P = P;
  p.TOK = tok;
  p.tiles = tiles;
  p.chunks = chunks;
  p.S = split;
  p.PB = pb;
  p.d = dropout(key, thresh, inv_keep, drop);
  FinishParams f;
  f.dk_part = dk_part;
  f.dv_part = dv_part;
  f.dq_part = dq_part;
  f.dk = dk;
  f.dv = dv;
  f.dqn = dqn;
  f.chunks = chunks;
  f.groups = HP / P * split;
  f.n_kv = (long long)B * C * HP;
  f.n_q = (long long)B * N * C;
  f.dk_bf16 = dk_bf16;
  f.dv_bf16 = dv_bf16;
  f.dq_bf16 = sizeof(E) == 2;
  return launch_bwd_wide(p, f, B, stream);
}

}  // namespace

// K3, the wide instances (C15) and, with f32 = 1, the f32 instances (C18):
// tok tokens a block, grid (ceil(N / tok), B), pb columns of a head staged
// at a time (kernels/spatial_attn.py::wide_plan); qn, kpb, vpb and out
// bf16, or f32 with f32 = 1
extern "C" int fcd_spatial_attn_fwd_wide(const void* qn, const void* kpb,
                                         const void* vpb, void* out, int B,
                                         int N, int C, int HP, int P, int tok,
                                         int pb, int f32, unsigned key,
                                         unsigned thresh, float inv_keep,
                                         int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? fwd_wide<float>(qn, kpb, vpb, out, B, N, C, HP, P, tok, pb,
                               key, thresh, inv_keep, drop, s)
             : fwd_wide<bf16>(qn, kpb, vpb, out, B, N, C, HP, P, tok, pb,
                              key, thresh, inv_keep, drop, s);
}

// K4 and its finishing pass, the wide instances and (f32 = 1) the f32
// ones: tok tokens a step, chunks of the ceil(N / tok) tiles, each head's
// P columns split over `split` blocks, pb columns staged at a time.
// Scratch: dk_part, dv_part (chunks, B, C, HP) f32 each; dq_part (HP / P *
// split, B, N, C) f32. dk and dv: f32, or bf16 where dk_bf16 / dv_bf16;
// dqn in the operands' type.
extern "C" int fcd_spatial_attn_bwd_wide(
    const void* qn, const void* kpb, const void* vpb, const void* g,
    void* dqn, float* dq_part, float* dk_part, float* dv_part, void* dk,
    void* dv, int dk_bf16, int dv_bf16, int B, int N, int C, int HP, int P,
    int tok, int chunks, int split, int pb, int f32, unsigned key,
    unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? bwd_wide<float>(qn, kpb, vpb, g, dqn, dq_part, dk_part,
                               dv_part, dk, dv, dk_bf16, dv_bf16, B, N, C,
                               HP, P, tok, chunks, split, pb, key, thresh,
                               inv_keep, drop, s)
             : bwd_wide<bf16>(qn, kpb, vpb, g, dqn, dq_part, dk_part,
                              dv_part, dk, dv, dk_bf16, dv_bf16, B, N, C, HP,
                              P, tok, chunks, split, pb, key, thresh,
                              inv_keep, drop, s);
}
