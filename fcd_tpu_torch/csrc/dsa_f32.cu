// B5 in f32: the fused eval dual self-attention (every sa_type) for a
// model that computes in f32, on the tensor cores as 3xTF32 (Hopper,
// sm_90a): phase A, its finishing pass, phase B. Three launches a call.
//
// Replaces fcd_tpu/kernels/dsa_attention.py::dsa_fused where the JAX
// package runs it in f32 (its phase A pallas_call :243, the XLA glue
// :277-300, its phase B pallas_call :310): a model built with
// use_amp=False runs the DSA's Pallas kernels in f32, and every rounding
// point of the bf16 function (dsa.cu's header) is then an f32 no-op
// (fcd_tpu/kernels/dsa_attention.py:70,111,115,148,154,160,168). The
// function is dsa.cu's with those roundings gone:
//   t = x + pe,  xln = LN(t) * ln_scale + ln_bias
//   q, k, v_ca, v_sa = xln @ w[:, slot * C ...]    (per head h: its CH
//                      columns of each slot)
//   phase A: qk_h = q_h^T k_h, q2 = sum q^2, k2 = sum k^2, kp = k^T ef,
//            vp = v_sa^T ef  (sums over the tokens)
//   finish:  qnorm = rsqrt(q2 + 1e-12), knorm likewise,
//            abig_h = softmax_row(qk_h * qnorm * knorm * t1_h)^T,
//            kpt = kp * t2_h
//   phase B: qn = q * qnorm, out_ca = v_ca abig_h, s = softmax_p(qn kpt_h),
//            out_sa = s vp_h^T, y = t + gamma * (out_ca + out_sa)
// with the sa_types of dsa.cu ('serial': out = out_sa abig_h; 'spatial':
// out_sa alone; 'channel': out_ca from v, no EF, P = 0). Tokens, weights,
// EF, pos-embed and the outputs are f32, and so is every intermediate:
// every product above (the projections, q^T k, kp | vp, and phase B's
// scores, s vp^T and channel attention) runs on the tensor cores as
// 3xTF32 (csrc/tf32x3.cuh: each operand split into two TF32 parts, three
// TF32 products in f32 accumulators, within a few f32 roundings of the
// IEEE product), each tensor-core chain at most KSEG deep and the chains
// added in f32; the LayerNorm, q2, k2, the softmaxes and the residual are
// f32 on the CUDA cores.
//
// What bounds it (H100: 495 TFLOP/s TF32, so 165 for 3xTF32's three
// products, and 3.35 TB/s): per token each phase reads ~8C + 4P bytes and
// does ~6C^2 + 4CP operations: 29 operations a byte at level 3 (C 32,
// under the card's ~49: the bytes) and ~190 at level 6 (C 256: the
// operations). The bound is 1-5 us a phase at the four levels, so what
// costs is latency: loads waited for one at a time, long dependent
// chains, barriers, too few blocks for 132 SMs. The design:
//   * The grids are dsa.cu's, (token chunk or tile, head, batch), with
//     the tiles, chunks, column groups and heads a block from
//     kernels/dsa_attention.py::dsa_plan_f32 (pure Python). A block issues
//     its tile's raw x, pe and ef rows and its heads' weight columns by
//     cp.async at once, LayerNorms the tile from shared memory (C / 4 up to
//     32 lanes a token, four channels a lane in registers up to C = 128),
//     then projects it on the tensor cores, each warp
//     one unit of 16 tokens x up to MJ n-tiles of 8 columns with its sums
//     in registers over C (the plan picks tiles for which one unit a warp
//     covers the projection). The weights stay resident for all the
//     block's tiles where they fit beside the rest (wrows), else stream
//     over C in KC-row chunks through two stages, the next chunk in flight
//     while the warps multiply this one (C 512's widest heads).
//   * Phase A then takes the token-contracted sums q^T k and
//     [k | v_sa]^T ef on the tensor cores from the staged q | k | v_sa
//     (the tokens as the k-dimension), q2 and k2 on the CUDA cores
//     (NT / (2 QW) lanes a column, a fixed tree). Each tile's sums start
//     from zero and are added in f32 to the chunk's record in device
//     memory by the thread that owns them (no other thread touches it).
//     With tiles of 64 tokens and more the warps split the tile's tokens
//     (sums_split: short tensor-core chains, every output tile of a unit
//     in one warp, the warps' partials added in warp order through the
//     dead x | pe rows), else each warp owns whole units over the tile. At
//     small levels a head's blocks split into G column groups (ParamsA::G,
//     the plan's `groups`: level 6's 4 tiles x 4 heads become 128 blocks):
//     group s projects its CH / G columns of q and v_sa and all of k, and
//     writes its rows of q^T k, q2, k2, kp and vp.
//   * The finishing pass adds the chunks' records in chunk order, as
//     dsa.cu's does, and writes phase B's operands in f32, its q^T k sums
//     and their glue split by rows over blocks (each also adds all of k2,
//     which every row's softmax reads), one value a thread. No atomics: two
//     calls give the same bits.
//   * Phase B takes HB heads a block (ParamsB::HB, the plan's `hb`: level
//     3 two, so a tile's tokens are read and LayerNormed once for both),
//     stages each head's kpt, vp and abig (head widths up to 64; at 128,
//     64 KB of abig alone, the products read them through the L1 cache) and
//     qnorm with the tile, and projects qn = q qnorm and v_ca of every head
//     at once. With tiles of 64 tokens and more (rows_whole) each warp then
//     takes 16 whole rows of a head from the scores to y: the softmax over
//     P on the scores' accumulators (quad shuffles), s and s vp^T through
//     the warp's own slab of shared memory, the channel attention's
//     accumulators giving y = t + gamma * out straight to device memory,
//     no block barrier after the projection. Smaller tiles spread each
//     product over the warps, the softmax a warp a token.
// The prologue-free instance (libdsa_f32_raw: this source built with
// -DFCD_DSA_RAW, FUSED false) is dsa.cu's, in f32: xln = x as staged (no
// LayerNorm, no pos-embed), y = out, and it reads no ln_scale, ln_bias, pe
// or gamma pointer; the plans, shared memory and products are the fused
// form's.
// Widths: every (C, P, heads) that dsa.cu takes (head width 2-128, P 0 or
// 16-128, C a power of two from 8 to 512); one instance of each kernel
// serves them all. Head widths 2 and 4 are staged padded with zero
// columns to 8 (padded), which add nothing to any product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int NT = 256;            // threads of a phase A or B block
constexpr int NW = NT / 32;
constexpr int FT = 1024;           // threads of a finishing-pass block
constexpr int SMEM_CAP = 232448;   // shared memory one block may hold
constexpr int KC = 32;             // weight rows (of C) a streamed chunk
constexpr int MJ = 8;              // n-tiles of a warp's unit, at most
constexpr int KSEG = 32;           // the depth of one tensor-core chain
constexpr int STREAM_CH = 128;     // head widths whose phase B reads kpt,
                                   // vp and abig where they lie
constexpr int SLACK = 16;          // floats past phase A's q | k | v_sa
                                   // that an 8-column slot's 16-row
                                   // fragments read (and drop)
constexpr float L2_EPS = 1e-12f;   // fcd_tpu/ops/attention.py::_l2_normalize
#ifdef FCD_DSA_RAW
constexpr bool FUSED = false;      // the prologue-free instance
#else
constexpr bool FUSED = true;       // pos-embed + LayerNorm, the residual
#endif

enum Mode { PARALLEL = 0, SERIAL = 1, SPATIAL = 2, CHANNEL = 3 };

// row pitches (floats) of the staged operands, so that the scalar
// fragment loads of tf32x3.cuh hit distinct banks: prow (4 mod 8) for an
// operand read along its rows (A stored M x K, B stored N x K), pcol (8
// mod 16) for one read down its columns (A stored K x M, B stored K x N)
// (kernels/dsa_attention.py::_prow, _pcol)
__host__ __device__ constexpr int prow(int n) { return (n + 3) / 8 * 8 + 4; }
__host__ __device__ constexpr int pcol(int n) {
  return (n + 7) / 16 * 16 + 8;
}

// a head's columns as staged: ch, padded with zero columns to mma's n = 8
__host__ __device__ constexpr int padded(int ch) { return ch < 8 ? 8 : ch; }

// weight rows a chunk: KC, or all of a C under KC
__host__ __device__ constexpr int kc_of(int c) { return c < KC ? c : KC; }

// phase A's projected columns: the group's q (CHP / G), the head's k
// (CHP), the group's v_sa (CHP / G; none for 'channel', P = 0)
__host__ __device__ constexpr int cols_a(int chp, int g, int p) {
  return chp + (p > 0 ? 2 : 1) * (chp / g);
}

// an mt x nt grid of m16n8 tiles as warp units: nj n-tiles a unit, per_m
// units an m-tile; the n-tiles spread over the warps an m-tile has
struct Units {
  int nj, per_m, units;
};

__host__ __device__ inline Units units_of(int mt, int nt) {
  const int groups = NW / mt > 1 ? NW / mt : 1;
  Units u;
  u.nj = (nt + groups - 1) / groups;
  if (u.nj > MJ) u.nj = MJ;
  u.per_m = (nt + u.nj - 1) / u.nj;
  u.units = mt * u.per_m;
  return u;
}

// a T x nc projection is one unit a warp at most (its sums stay in the
// warp's registers across the chunks of C)
__host__ __device__ inline bool projects(int T, int nc) {
  return units_of(T / 16, nc / 8).units <= NW;
}

// the weight rows a block holds: all C (staged once, resident) where the
// block's shared memory then stays within SMEM_CAP, else two stages of
// kc_of(C) rows streamed a tile; `other` floats of the rest
__host__ __device__ inline int wrows(int C, int wp, int other) {
  return 4 * (C * wp + other) <= SMEM_CAP ? C : 2 * kc_of(C);
}

// phase A's floats beside the weights: the tile's x and pe rows, its ef
// rows, q | k | v_sa
__host__ __device__ inline int rest_a(int C, int CH, int P, int T, int G) {
  const int nc = cols_a(padded(CH), G, P);
  return 2 * T * prow(C) + (P > 0 ? T * pcol(P) : 0) + T * pcol(nc) + SLACK;
}

__host__ __device__ inline int smem_a(int C, int CH, int P, int T, int G) {
  const int wp = pcol(cols_a(padded(CH), G, P)), o = rest_a(C, CH, P, T, G);
  return 4 * (wrows(C, wp, o) * wp + o);
}

// whether each of phase B's warps takes 16 whole rows of the tile from
// the scores to y (P / 8 and CHP / 8 n-tiles a unit; tiles of 64 tokens
// and more, so that four warps or more take part), the softmax on the
// scores' accumulators and s and the spatial output in a slab of 16 rows
// of its own
__host__ __device__ inline bool rows_whole(int T, int P, int CHP) {
  return T >= 64 && P > 0 && P / 8 <= MJ && CHP / 8 <= MJ;
}

// phase B's rows of the scores and the spatial output: a 16-row slab a
// warp (rows_whole), else the tile's
__host__ __device__ inline int s_rows(int T, int P, int CHP) {
  return rows_whole(T, P, CHP) ? 16 * NW : T;
}

// whether phase B's scores lie over the tile's x and pe rows, dead once
// the tile is projected
__host__ __device__ inline bool s_on_x(int C, int P, int T, int CHP) {
  return P > 0 && s_rows(T, P, CHP) * prow(P) <= 2 * T * prow(C);
}

// phase B's floats beside the weights, for HB heads a block: x and pe
// rows, t of the heads' channels, qn | v, qnorm; the scores (unless over
// x and pe) and the spatial output; abig_h, kpt_h, vp_h of each head
// where staged
__host__ __device__ inline int rest_b(int C, int CH, int P, int T, int HB) {
  const int chp = padded(CH), sr = s_rows(T, P, chp);
  int f = 2 * T * prow(C) + T * HB * chp + T * prow(2 * HB * chp) + HB * chp;
  if (P > 0)
    f += (s_on_x(C, P, T, chp) ? 0 : sr * prow(P)) + sr * prow(chp);
  if (CH < STREAM_CH)
    f += HB * (chp * pcol(chp) + (P > 0 ? chp * pcol(P) + chp * prow(P) : 0));
  return f;
}

__host__ __device__ inline int smem_b(int C, int CH, int P, int T, int HB) {
  const int wp = pcol(2 * HB * padded(CH)), o = rest_b(C, CH, P, T, HB);
  return 4 * (wrows(C, wp, o) * wp + o);
}

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

// 16-byte cp.async; valid false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x n floats from src (row stride ld) into shared dst (pitch dp) by
// cp.async: 16 bytes a copy, or 8 where n is 2 (head width 2)
__device__ void stage_rows(float* dst, int dp, const float* src, size_t ld,
                           int rows, int n) {
  const int V = n % 4 == 0 ? 4 : 2, per = n / V;
  for (int v = threadIdx.x; v < rows * per; v += NT) {
    const int r = v / per, c = (v - r * per) * V;
    if (V == 4)
      cp_async16(dst + r * dp + c, src + r * ld + c, true);
    else
      cp_async8(dst + r * dp + c, src + r * ld + c);
  }
}

// what both phases read
struct Tok {
  const float* x;    // (B, N, C) raw tokens
  const float* pe;   // (N, C) pos-embed, or null
  const float* lns;  // (C,) LayerNorm scale
  const float* lnb;  // (C,) LayerNorm bias
  const float* w;    // the flax qkvv matrix (C, nslot C)
  int nslot;         // 4 ('parallel') or 3 (the other modes)
  int N, C, heads, T;  // T tokens a tile
  float eps;
};

// a slot's columns as a block stages them: flax columns src .. src + real
// into stage columns dst .. dst + real, and zeros up to dst + width
struct Seg {
  int src, real, dst, width;
};

// weight rows r0 .. r0 + kc of the segments into one stage (pitch wp)
__device__ void stage_w(const Tok& tk, const Seg* sg, int ns, int r0, int kc,
                        float* W, int wp) {
  const size_t ld = (size_t)tk.nslot * tk.C;
  for (int i = 0; i < ns; ++i)
    stage_rows(W + sg[i].dst, wp, tk.w + r0 * ld + sg[i].src, ld, kc,
               sg[i].real);
}

// the zero columns of the held weight rows (head widths under 8);
// cp.async never writes them
__device__ void zero_pads(const Seg* sg, int ns, int rows, float* W,
                          int wp) {
  for (int i = 0; i < ns; ++i) {
    const int pad = sg[i].width - sg[i].real;
    for (int v = threadIdx.x; v < rows * pad; v += NT)
      W[(v / pad) * wp + sg[i].dst + sg[i].real + v % pad] = 0.f;
  }
}

// token rows n0 .. n0 + T of batch item b: x into Xs and pe into Ps
// (pitch xp), rows past N zero; with Es, the ef rows (pitch ep)
__device__ void stage_tile(const Tok& tk, int b, int n0, float* Xs,
                           float* Ps, int xp, const float* ef, float* Es,
                           int P, int ep) {
  const int C = tk.C, cv = C / 4;
  for (int v = threadIdx.x; v < tk.T * cv; v += NT) {
    const int t = v / cv, c = (v - t * cv) * 4;
    const bool ok = n0 + t < tk.N;
    const size_t n = ok ? n0 + t : 0;
    cp_async16(Xs + t * xp + c, tk.x + ((size_t)b * tk.N + n) * C + c, ok);
    if (tk.pe != nullptr) cp_async16(Ps + t * xp + c, tk.pe + n * C + c, ok);
  }
  if (Es == nullptr) return;
  const int pv = P / 4;
  for (int v = threadIdx.x; v < tk.T * pv; v += NT) {
    const int t = v / pv, q = (v - t * pv) * 4;
    const bool ok = n0 + t < tk.N;
    cp_async16(Es + t * ep + q, ef + (size_t)(ok ? n0 + t : 0) * P + q, ok);
  }
}

// the staged tile LayerNormed in place: Xs = LN(x + pe) * lns + lnb, rows
// past N zero; with Bs, t = x + pe of the channels c0 .. c0 + CH into Bs
// (pitch bp). L = min(C / 4, 32) consecutive lanes a token (lane l:
// channels l, l + L, ...), the sums added over the L lanes by a fixed
// tree; var = E[t^2] - mean^2 clamped at 0, as ops/layers.py::layer_norm
// computes it. Up to C = 128 a lane's four channels, with their scale and
// bias, stay in registers (one pass over shared memory); wider rows are
// read twice.
__device__ void ln_tile(const Tok& tk, int n0, float* Xs, const float* Ps,
                        int xp, float* Bs, int c0, int CH, int bp) {
  const int C = tk.C, L = C / 4 < 32 ? C / 4 : 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % L, per_warp = 32 / L;
  const bool four = C == 4 * L;  // C <= 128: four channels a lane
  float sc[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sc[i] = four ? __ldg(tk.lns + sub + i * L) : 0.f;
    sh[i] = four ? __ldg(tk.lnb + sub + i * L) : 0.f;
  }
  for (int t0 = warp * per_warp; t0 < tk.T; t0 += NW * per_warp) {
    const int t = t0 + lane / L;
    const bool valid = n0 + t < tk.N;
    float* row = Xs + t * xp;
    const float* pr = Ps + t * xp;
    float s = 0.f, q = 0.f, v[4];
    if (four) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = sub + i * L;
        v[i] = valid ? row[c] + (tk.pe != nullptr ? pr[c] : 0.f) : 0.f;
        s += v[i];
        q += v[i] * v[i];
      }
    } else {
      for (int c = sub; c < C; c += L) {
        const float x = valid ? row[c] + (tk.pe != nullptr ? pr[c] : 0.f)
                              : 0.f;
        row[c] = x;
        s += x;
        q += x * x;
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    const float mu = s / C;
    const float rstd = rsqrtf(fmaxf(q / C - mu * mu, 0.f) + tk.eps);
    if (four) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = sub + i * L;
        if (Bs != nullptr && c >= c0 && c < c0 + CH)
          Bs[t * bp + c - c0] = v[i];
        row[c] = valid ? (v[i] - mu) * rstd * sc[i] + sh[i] : 0.f;
      }
      continue;
    }
    for (int c = sub; c < C; c += L) {
      const float x = row[c];
      if (Bs != nullptr && c >= c0 && c < c0 + CH) Bs[t * bp + c - c0] = x;
      row[c] = valid ? (x - mu) * rstd * __ldg(tk.lns + c) + __ldg(tk.lnb + c)
                     : 0.f;
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[MJ][4]) {
#pragma unroll
  for (int j = 0; j < MJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc = A . B over k = 0 .. K (a multiple of 8) on 3xTF32 (warp_mma_tf32's
// layouts), one tensor-core chain per KSEG of k, the chains added in f32
template <bool AKM, bool BNK>
__device__ __forceinline__ void seg_mma(float (&acc)[MJ][4], int nj,
                                        const float* A, int ap, int m0,
                                        const float* B, int bp, int n0,
                                        int K, int lane) {
  zero(acc);
  for (int k = 0; k < K; k += KSEG) {
    float part[MJ][4];
    zero(part);
    warp_mma_tf32<AKM, BNK, MJ>(part, nj, A + (AKM ? k * ap : k), ap, m0,
                                B + (BNK ? k : k * bp), bp, n0,
                                min(KSEG, K - k), lane);
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }
}

// this warp's unit (m-tile um, n-tiles un .. un + nj; none where `unit`
// is false) of the tile's projection Xs . W over C, in chunks of kc rows:
// resident weights hold every chunk (issued by the caller); streamed ones
// hold chunk i in stage i & 1, chunk 0 issued by the caller and chunk i +
// 1 staged while the warps multiply chunk i. Every thread takes part
// (barriers); the first barrier also publishes the caller's LayerNorm of
// Xs.
__device__ void project(const Tok& tk, const Seg* sg, int ns, const float* Xs,
                        int xp, float* W, int wp, bool resident, bool unit,
                        int um, int un, int nj, float (&acc)[MJ][4]) {
  const int lane = threadIdx.x & 31, kc = kc_of(tk.C), nck = tk.C / kc;
  zero(acc);
  for (int i = 0; i < nck; ++i) {
    if (!resident || i == 0) {
      cp_async_wait_all();
      __syncthreads();  // chunk i is in; chunk i - 1's stage is free
    }
    if (!resident && i + 1 < nck) {
      stage_w(tk, sg, ns, (i + 1) * kc, kc, W + ((i + 1) & 1) * kc * wp, wp);
      cp_async_commit();
    }
    if (!unit) continue;
    float part[MJ][4];
    seg_mma<false, false>(part, nj, Xs + i * kc, xp, um * 16,
                          W + (resident ? i : i & 1) * kc * wp, wp, un * 8,
                          kc, lane);
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
  }
}

// a unit's accumulators into D (pitch dp); columns under nsc times sc[col]
__device__ __forceinline__ void store_unit(const float (&acc)[MJ][4], int nj,
                                           int m0, int n0, float* D, int dp,
                                           const float* sc, int nsc,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    if (j >= nj) break;
    const int c = n0 + 8 * j + 2 * t4;
    const float s0 = c < nsc ? sc[c] : 1.f, s1 = c + 1 < nsc ? sc[c + 1] : 1.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(D + (m0 + g + 8 * hf) * dp + c) =
          make_float2(acc[j][2 * hf] * s0, acc[j][2 * hf + 1] * s1);
  }
}

// ---- phase A ---------------------------------------------------------------

struct ParamsA {
  Tok tk;
  int mode;
  const float* ef;  // (N, P); null at P = 0
  int P;
  float* part;      // (chunks, B, heads, F) partial records
  int tiles, per_chunk;
  int G;            // column groups a head's blocks split into
};

// one product of phase A's sums: out = A^T B over the tile's tokens, A
// (mt m-tiles) and B (nt n-tiles) stored tokens x columns; output row m
// goes to record offset ro + m rs (rows from `split` on to ro2 + (m -
// split) rs), column n to + n; rows m (after the split) >= mv and columns
// >= nv are dropped
struct SumJob {
  const float* A;
  const float* B;
  int bp, mt, nt, mv, nv, split, ro, ro2, rs;
};

// the tile's sums of the jobs, each unit's from zero, added in f32 to the
// record (written at the chunk's first tile) by the lane that owns them
__device__ void tile_sums(const SumJob* jobs, int njobs, int T, int ap,
                          float* rec, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int base = 0;
  for (int jb = 0; jb < njobs; ++jb) {
    const SumJob& J = jobs[jb];
    const Units U = units_of(J.mt, J.nt);
    for (int u = (warp - base % NW + NW) % NW; u < U.units; u += NW) {
      const int mi = u / U.per_m, nt0 = (u - mi * U.per_m) * U.nj;
      const int nj = min(U.nj, J.nt - nt0);
      float acc[MJ][4];
      seg_mma<true, false>(acc, nj, J.A, ap, mi * 16, J.B, J.bp, nt0 * 8, T,
                           lane);
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (j >= nj) break;
        const int n = (nt0 + j) * 8 + 2 * t4;
        if (n >= J.nv) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int m = mi * 16 + g + 8 * hf, ro = J.ro;
          if (m >= J.split) m -= J.split, ro = J.ro2;
          if (m >= J.mv) continue;
          float2* r = reinterpret_cast<float2*>(rec + ro + m * J.rs + n);
          float2 v = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
          if (!first) {
            const float2 o = *r;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *r = v;
        }
      }
    }
    base += U.units;
  }
}

// whether phase A's warps split the tile's tokens for the sums: tiles of
// 64 tokens and more, whose x | pe rows (dead once the tile is projected)
// hold the warps' partials of a unit (NW x MJ m16n8 tiles)
__host__ __device__ inline bool sums_split(int T, int C) {
  return T >= 64 && 2 * T * prow(C) >= NW * MJ * 128;
}

constexpr int RED_K = MJ * 128 / NT;  // a unit's fragment elements a thread

// tile_sums with the tokens split over the warps (sums_split): unit by
// unit (an m-tile and up to MJ n-tiles of a job), each warp sums its T /
// NW tokens into every tile of the unit (one short tensor-core chain a
// tile, all the warp's tiles independent), the partials go to `red`, and
// the threads add them in warp order, each fragment element's sum then
// added in f32 to the record by the thread that owns it
__device__ void tile_sums_split(const SumJob* jobs, int njobs, int T, int ap,
                                float* red, float* rec, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, kt = T / NW;
  for (int jb = 0; jb < njobs; ++jb) {
    const SumJob& J = jobs[jb];
    const int per_m = (J.nt + MJ - 1) / MJ;
    for (int u = 0; u < J.mt * per_m; ++u) {
      const int mi = u / per_m, nt0 = (u - mi * per_m) * MJ;
      const int nj = min(MJ, J.nt - nt0);
      float acc[MJ][4];
      seg_mma<true, false>(acc, nj, J.A + warp * kt * ap, ap, mi * 16,
                           J.B + warp * kt * J.bp, J.bp, nt0 * 8, kt, lane);
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (j >= nj) break;
        *reinterpret_cast<float4*>(red + ((warp * MJ + j) * 32 + lane) * 4) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
      __syncthreads();
      // a thread's fragment elements i = threadIdx.x + k NT (k < RED_K):
      // their record values' loads all go out before any store
      float* r[RED_K];
      float old[RED_K];
#pragma unroll
      for (int k = 0; k < RED_K; ++k) {
        const int i = threadIdx.x + k * NT;
        const int j = i >> 7, l = (i >> 2) & 31, e = i & 3;
        int m = mi * 16 + (l >> 2) + 8 * (e >> 1), ro = J.ro;
        const int n = (nt0 + j) * 8 + 2 * (l & 3) + (e & 1);
        if (m >= J.split) m -= J.split, ro = J.ro2;
        r[k] = i < nj * 128 && m < J.mv && n < J.nv ? rec + ro + m * J.rs + n
                                                    : nullptr;
        old[k] = r[k] != nullptr && !first ? *r[k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RED_K; ++k) {
        const int i = threadIdx.x + k * NT, j = i >> 7, f = i & 127;
        if (r[k] == nullptr) continue;
        float v = 0.f;
        for (int w = 0; w < NW; ++w) v += red[(w * MJ + j) * 128 + f];
        *r[k] = first ? v : old[k] + v;
      }
      __syncthreads();  // red is free
    }
  }
}

// grid (chunk, head x G, batch): the chunk's token tiles, column group s of
// head h; the record [qk (CH x CH) | q2 | k2 (CH) | kp (CH x P) | vp (CH x
// P)], group s its rows s CH / G ..
__global__ void __launch_bounds__(NT, 2) dsa_f32_phase_a_kernel(
    const ParamsA p) {
  extern __shared__ __align__(16) float sm[];
  const Tok& tk = p.tk;
  const int C = tk.C, T = tk.T, P = p.P, CH = C / tk.heads;
  const int CHP = padded(CH), G = p.G, QW = CHP / G;
  const int chunk = blockIdx.x, h = blockIdx.y / G, s = blockIdx.y % G;
  const int b = blockIdx.z, c0 = h * CH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = cols_a(CHP, G, P), wp = pcol(nc), xp = prow(C);
  const int ep = pcol(P), kc = kc_of(C);
  const int rows = wrows(C, wp, rest_a(C, CH, P, T, G));
  const bool resident = rows == C;
  float* W = sm;                 // C x nc, or two stages of kc x nc
  float* Xs = W + rows * wp;     // T x C
  float* Ps = Xs + T * xp;       // T x C
  float* Es = Ps + T * xp;       // T x P
  float* Qs = Es + (P > 0 ? T * ep : 0);  // q (QW) | k (CHP) | v_sa (QW)
  const int NO = CH * CH + 2 * CH, F = NO + 2 * CH * P;
  float* rec = p.part + (((size_t)chunk * gridDim.z + b) * tk.heads + h) * F;
  const int real = G > 1 ? QW : CH;
  const Seg sg[3] = {{c0 + s * QW, real, 0, QW},
                     {C + c0, CH, QW, CHP},
                     {(p.mode == PARALLEL ? 3 : 2) * C + c0 + s * QW, real,
                      QW + CHP, QW}};
  const int ns = P > 0 ? 3 : 2;
  zero_pads(sg, ns, rows, W, wp);
  const Units pu = units_of(T / 16, nc / 8);
  const bool unit = warp < pu.units;
  const int um = warp / pu.per_m, un = (warp % pu.per_m) * pu.nj;
  const int unj = min(pu.nj, nc / 8 - un);
  // q^T k (rows: the group's q columns), and kp | vp: for one group the
  // staged k | v_sa as one product of 2 CHP rows, else kp and vp apart
  SumJob jobs[3];
  jobs[0] = {Qs, Qs + QW, wp, (QW + 15) / 16, CHP / 8, min(QW, CH), CH, 1 << 30,
             s * QW * CH, 0, CH};
  int njobs = 1;
  if (P > 0 && G == 1) {
    jobs[njobs++] = {Qs + QW, Es, ep, 2 * CHP / 16, P / 8, CH, P, CHP, NO,
                     NO + CH * P, P};
  } else if (P > 0) {
    jobs[njobs++] = {Qs + QW + s * QW, Es, ep, (QW + 15) / 16, P / 8, QW, P,
                     1 << 30, NO + s * QW * P, 0, P};
    jobs[njobs++] = {Qs + QW + CHP, Es, ep, (QW + 15) / 16, P / 8, QW, P,
                     1 << 30, NO + CH * P + s * QW * P, 0, P};
  }
  const bool split = sums_split(T, C);
  const int t0 = chunk * p.per_chunk;
  const int t1 = min(t0 + p.per_chunk, p.tiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * T;
    const bool first = tile == t0;
    stage_tile(tk, b, n0, Xs, Ps, xp, p.ef, P > 0 ? Es : nullptr, P, ep);
    if (first || !resident) stage_w(tk, sg, ns, 0, resident ? C : kc, W, wp);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if constexpr (FUSED) ln_tile(tk, n0, Xs, Ps, xp, nullptr, 0, CH, 0);
    float acc[MJ][4];
    project(tk, sg, ns, Xs, xp, W, wp, resident, unit, um, un, unj, acc);
    if (unit) store_unit(acc, unj, um * 16, un * 8, Qs, wp, nullptr, 0, lane);
    __syncthreads();
    // q2 and k2 of the group's 2 QW columns: NT / (2 QW) consecutive
    // lanes a column (2 QW is 16 .. 256), each every tpc-th token, then a
    // fixed tree over the lanes
    const int tpc = NT / (2 * QW), ci = threadIdx.x / tpc;
    const int kk = ci >= QW, col = s * QW + ci - kk * QW;
    const float* src = Qs + (kk ? QW + col : ci);
    float sum = 0.f;
    for (int t = threadIdx.x % tpc; t < T; t += tpc)
      sum = fmaf(src[t * wp], src[t * wp], sum);
    for (int o = tpc / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (threadIdx.x % tpc == 0 && col < CH) {
      float* r = rec + CH * CH + kk * CH + col;
      *r = first ? sum : *r + sum;
    }
    if (split)
      tile_sums_split(jobs, njobs, T, wp, Xs, rec, first);
    else
      tile_sums(jobs, njobs, T, wp, rec, first);
    __syncthreads();  // the tile's buffers are free
  }
}

struct ParamsF {
  const float* part;
  int chunks, heads, C, CH, P;
  int rb;           // rows of q^T k a row block takes
  int glue;
  const float* t1;  // (heads,) temperature
  const float* t2;  // (heads,) temperature2
  // glue == 0, phase A's sums: qk (B, heads, CH, CH), q2, k2 (B, C), kp,
  // vp (B, C, P)
  float *qk, *q2, *k2, *kp, *vp;
  // glue == 1, phase B's operands: qnorm (B, C), abig (B, heads, CH, CH),
  // kpt, vpb (B, C, P)
  float *qnorm, *abig, *kpt, *vpb;
};

// the records' value f added over the chunks, in chunk order; the loads
// go out 16 at a time, ahead of the adds
__device__ __forceinline__ float chunk_sum(const float* src, size_t stride,
                                           int chunks) {
  constexpr int G = 16;
  float s = 0.f;
  for (int k = 0; k < chunks; k += G) {
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      v[j] = k + j < chunks ? __ldcg(src + (size_t)(k + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (k + j < chunks) s += v[j];
  }
  return s;
}

constexpr int SOFTMAX_COLS = 4;  // columns a lane in the softmax: CH <= 128

// the rows of q^T k a row block of the finishing pass takes: the most (a
// power of two up to CH) whose sums, with q2 of those rows and all of k2,
// are one value a thread
__host__ __device__ inline int finish_rows(int CH) {
  int rb = CH;
  while (rb > 1 && rb * (CH + 1) + CH > FT) rb /= 2;
  return rb;
}

// grid (row blocks + kv blocks, head, batch), FT threads (dsa.cu's
// dsa_phase_a_finish, f32 out, split by rows): row block j adds rows j rb
// .. j rb + rb of q^T k, their q2 and all of k2, and (glue) does those
// rows' glue; the others add FT values each of kp | vp
__global__ void __launch_bounds__(FT) dsa_f32_phase_a_finish(
    const ParamsF p) {
  const int h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int CH = p.CH, P = p.P, C = p.C, RB = p.rb;
  const int NO = CH * CH + 2 * CH, F = NO + 2 * CH * P;
  const int row_blocks = CH / RB;
  const size_t stride = (size_t)B * p.heads * F;  // one chunk's records
  const float* src = p.part + ((size_t)b * p.heads + h) * F;
  const size_t row = (size_t)b * C + h * CH;  // the head's first channel
  if (blockIdx.x >= row_blocks) {
    const int g = (blockIdx.x - row_blocks) * FT + threadIdx.x;
    if (g >= 2 * CH * P) return;
    const float s = chunk_sum(src + NO + g, stride, p.chunks);
    const bool is_vp = g >= CH * P;
    const size_t i = row * P + (is_vp ? g - CH * P : g);
    if (!p.glue)
      (is_vp ? p.vp : p.kp)[i] = s;
    else
      (is_vp ? p.vpb : p.kpt)[i] = is_vp ? s : s * p.t2[h];
    return;
  }
  // this block's values: qk rows r0 .. r0 + RB (RB CH), their q2 (RB),
  // all of k2 (CH), into fs in that order
  const int r0 = blockIdx.x * RB, nv = RB * CH + RB + CH;
  extern __shared__ float fs[];  // the nv sums, then qnorm and knorm
  for (int i = threadIdx.x; i < nv; i += FT) {
    const int f = i < RB * CH ? r0 * CH + i
                  : i < RB * CH + RB ? CH * CH + r0 + i - RB * CH
                                     : CH * CH + CH + i - RB * CH - RB;
    fs[i] = chunk_sum(src + f, stride, p.chunks);
  }
  __syncthreads();
  const float* qk = fs;
  const float* q2 = fs + RB * CH;
  const float* k2 = q2 + RB;
  if (!p.glue) {
    for (int i = threadIdx.x; i < RB * CH; i += FT)
      p.qk[((size_t)b * p.heads + h) * CH * CH + r0 * CH + i] = qk[i];
    for (int i = threadIdx.x; i < RB; i += FT) p.q2[row + r0 + i] = q2[i];
    if (blockIdx.x == 0)
      for (int c = threadIdx.x; c < CH; c += FT) p.k2[row + c] = k2[c];
    return;
  }
  float* qn = fs + nv;
  float* kn = qn + RB;
  for (int i = threadIdx.x; i < RB; i += FT) {
    qn[i] = rsqrtf(q2[i] + L2_EPS);
    p.qnorm[row + r0 + i] = qn[i];
  }
  for (int c = threadIdx.x; c < CH; c += FT) kn[c] = rsqrtf(k2[c] + L2_EPS);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float t1 = p.t1[h];
  float* ab = p.abig + ((size_t)b * p.heads + h) * CH * CH;
  for (int r = warp; r < RB; r += FT / 32) {
    float v[SOFTMAX_COLS], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SOFTMAX_COLS; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < CH ? qk[r * CH + c] * qn[r] * kn[c] * t1 : -INFINITY;
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
      if (c < CH) ab[c * CH + r0 + r] = v[i] / sum;
    }
  }
}

// ---- phase B ---------------------------------------------------------------

struct ParamsB {
  Tok tk;
  int mode;
  int P;
  const float* qnorm;  // (B, C)
  const float* abig;   // (B, heads, CH, CH): out_ca[n, c] = sum_d v[n, d] abig[d, c]
  const float* kpt;    // (B, C, P); null at P = 0
  const float* vp;     // (B, C, P); null at P = 0
  const float* gamma;  // (C,)
  float* out;          // (B, N, C)
  int HB;              // heads a block
};

constexpr int MAX_HB = 4;  // heads a phase B block, at most

// each of the T rows of S (pitch sp) softmaxed over its P columns, a warp
// a row
__device__ void softmax_rows(float* S, int sp, int T, int P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += NW) {
    float* row = S + t * sp;
    float mx = -INFINITY;
    for (int q = lane; q < P; q += 32) mx = fmaxf(mx, row[q]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int q = lane; q < P; q += 32) {
      const float e = expf(row[q] - mx);
      row[q] = e;
      sum += e;
    }
    sum = 1.f / warp_sum(sum);
    __syncwarp();
    for (int q = lane; q < P; q += 32) row[q] *= sum;
  }
}

// the softmax over the columns of a warp's 16 whole rows held as the
// accumulators of nt n-tiles (row g in elements 0, 1; row g + 8 in 2, 3):
// each lane's maxima and sums, then the quad's (the four lanes of a row)
__device__ __forceinline__ void softmax_frags(float (&acc)[MJ][4], int nt) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], acc[j][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = expf(acc[j][e] - mx[e >> 1]);
      sum[e >> 1] += acc[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= sum[e >> 1];
  }
}

// grid (tile, head group, batch): heads h0 .. h0 + HB of the tile
__global__ void __launch_bounds__(NT, 2) dsa_f32_phase_b_kernel(
    const ParamsB p) {
  extern __shared__ __align__(16) float sm[];
  const Tok& tk = p.tk;
  const int C = tk.C, T = tk.T, P = p.P, CH = C / tk.heads, CHP = padded(CH);
  const int HB = p.HB, HC = HB * CHP;
  const int tile = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int c0 = h0 * CH, n0 = tile * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nc = 2 * HC, wp = pcol(nc), xp = prow(C), qp = prow(nc);
  const int sp = prow(P), op = prow(CHP), kc = kc_of(C);
  const int sr = s_rows(T, P, CHP);
  const bool staged = CH < STREAM_CH;
  const int rows = wrows(C, wp, rest_b(C, CH, P, T, HB));
  const bool resident = rows == C;
  float* W = sm;                 // C x (q | v), or two stages of kc rows
  float* Xs = W + rows * wp;     // T x C
  float* Ps = Xs + T * xp;       // T x C
  float* Bs = Ps + T * xp;       // t of the heads' channels, T x HC
  float* Qv = Bs + T * HC;       // qn of each head (HC) | v of each (HC)
  float* Qn = Qv + T * qp;       // qnorm of the heads' channels, HC
  const bool over = s_on_x(C, P, T, CHP);
  float* Ss = over ? Xs : Qn + HC;  // the scores, then s, sr x P
  float* Os = Qn + HC + (P > 0 && !over ? sr * sp : 0);  // out_sa, sr x CHP
  float* Ab = Os + (P > 0 ? sr * op : 0);  // abig of each head, CHP x CHP
  float* Kt = Ab + HB * CHP * pcol(CHP);   // kpt_h of each, CHP x P
  float* Vp = Kt + (P > 0 ? HB * CHP * pcol(P) : 0);  // vp_h of each
  // the products' operands of head j: staged, or (head width 128) where
  // they lie
  const int abp = staged ? pcol(CHP) : CH, ktp = staged ? pcol(P) : P;
  const int vvp = staged ? prow(P) : P;
  auto abig = [&](int j) {
    return p.abig + ((size_t)b * tk.heads + h0 + j) * CH * CH;
  };
  auto kpt = [&](int j) {
    return p.kpt + ((size_t)b * C + c0 + j * CH) * P;
  };
  auto vpg = [&](int j) {
    return p.vp + ((size_t)b * C + c0 + j * CH) * P;
  };
  Seg sg[2 * MAX_HB];
  for (int j = 0; j < HB; ++j) {
    sg[j] = {c0 + j * CH, CH, j * CHP, CHP};
    sg[HB + j] = {2 * C + c0 + j * CH, CH, HC + j * CHP, CHP};
  }
  zero_pads(sg, 2 * HB, rows, W, wp);
  stage_tile(tk, b, n0, Xs, Ps, xp, nullptr, nullptr, 0, 0);
  stage_w(tk, sg, 2 * HB, 0, resident ? C : kc, W, wp);
  if (staged) {
    for (int j = 0; j < HB; ++j) {
      float* ab = Ab + j * CHP * abp;
      stage_rows(ab, abp, abig(j), CH, CH, CH);
      if (P > 0) {
        stage_rows(Kt + j * CHP * ktp, ktp, kpt(j), P, CH, P);
        stage_rows(Vp + j * CHP * vvp, vvp, vpg(j), P, CH, P);
      }
      // the padding of head widths under 8: zero rows and columns
      for (int i = threadIdx.x; CH < CHP && i < CHP * CHP; i += NT)
        if (i / CHP >= CH || i % CHP >= CH) ab[(i / CHP) * abp + i % CHP] = 0.f;
      for (int i = threadIdx.x; i < (CHP - CH) * P; i += NT) {
        Kt[(j * CHP + CH + i / P) * ktp + i % P] = 0.f;
        Vp[(j * CHP + CH + i / P) * vvp + i % P] = 0.f;
      }
    }
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < HC; i += NT) {
    const int j = i / CHP, c = i - j * CHP;
    Qn[i] = c < CH ? p.qnorm[(size_t)b * C + c0 + j * CH + c] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (FUSED) ln_tile(tk, n0, Xs, Ps, xp, Bs, c0, HB * CH, HC);
  // q | v of every head (slots 0 and 2), q scaled by qnorm as it is stored
  const Units pu = units_of(T / 16, nc / 8);
  const bool unit = warp < pu.units;
  const int um = warp / pu.per_m, un = (warp % pu.per_m) * pu.nj;
  const int unj = min(pu.nj, nc / 8 - un);
  float acc[MJ][4];
  project(tk, sg, 2 * HB, Xs, xp, W, wp, resident, unit, um, un, unj, acc);
  if (unit) store_unit(acc, unj, um * 16, un * 8, Qv, qp, Qn, HC, lane);
  __syncthreads();
  // y = t + gamma * out (the prologue-free instance: out) for head j's unit (m-tile mi, n-tiles nt0 .. nt0 +
  // nj), the spatial output's rows mi * 16 .. in O from row om0: out_ca
  // (+ out_sa), out_sa alone, or out_sa abig
  auto output = [&](int j, int mi, int nt0, int nj, const float* O,
                    int om0) {
    const float* ab = staged ? Ab + j * CHP * abp : abig(j);
    float o[MJ][4];
    if (p.mode == SPATIAL)
      zero(o);
    else if (p.mode == SERIAL)
      seg_mma<false, false>(o, nj, O, op, om0, ab, abp, nt0 * 8, CHP, lane);
    else
      seg_mma<false, false>(o, nj, Qv + HC + j * CHP, qp, mi * 16, ab, abp,
                            nt0 * 8, CHP, lane);
#pragma unroll
    for (int jj = 0; jj < MJ; ++jj) {
      if (jj >= nj) break;
      const int c = (nt0 + jj) * 8 + 2 * t4;
      if (c >= CH) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mi * 16 + g + 8 * hf;
        if (n0 + r >= tk.N) continue;
        const float* orow = O + (om0 + g + 8 * hf) * op + c;
        float o0 = o[jj][2 * hf], o1 = o[jj][2 * hf + 1];
        if (p.mode == SPATIAL) {
          o0 = orow[0];
          o1 = orow[1];
        } else if (p.mode == PARALLEL) {
          o0 += orow[0];
          o1 += orow[1];
        }
        const int cc = c0 + j * CH + c;
        *reinterpret_cast<float2*>(p.out + ((size_t)b * tk.N + n0 + r) * C +
                                   cc) =
            FUSED ? make_float2(Bs[r * HC + j * CH + c] + p.gamma[cc] * o0,
                                Bs[r * HC + j * CH + c + 1] +
                                    p.gamma[cc + 1] * o1)
                  : make_float2(o0, o1);
      }
    }
  };
  const int mt = T / 16;
  if (rows_whole(T, P, CHP)) {
    // a warp 16 whole rows of a head, from the scores to y: the softmax on
    // the scores' accumulators, s and the spatial output through the
    // warp's own slab of Ss and Os (no block barrier)
    float* S = Ss + warp * 16 * sp;
    float* O = Os + warp * 16 * op;
    for (int q = warp; q < HB * mt; q += NW) {
      const int j = q / mt, mi = q - j * mt;
      seg_mma<false, false>(acc, P / 8, Qv + j * CHP, qp, mi * 16,
                            staged ? Kt + j * CHP * ktp : kpt(j), ktp, 0, CHP,
                            lane);
      softmax_frags(acc, P / 8);
      store_unit(acc, P / 8, 0, 0, S, sp, nullptr, 0, lane);
      __syncwarp();
      seg_mma<false, true>(acc, CHP / 8, S, sp, 0,
                           staged ? Vp + j * CHP * vvp : vpg(j), vvp, 0, P,
                           lane);
      store_unit(acc, CHP / 8, 0, 0, O, op, nullptr, 0, lane);
      __syncwarp();
      output(j, mi, 0, CHP / 8, O, 0);
      __syncwarp();  // the slab is free
    }
    return;
  }
  for (int j = 0; j < HB; ++j) {
    if (p.mode != CHANNEL) {
      // the scores s = qn kpt_h, their softmax over P (a warp a token),
      // the spatial output out_sa = s vp_h^T, each spread over the warps
      Units U = units_of(mt, P / 8);
      for (int u = warp; u < U.units; u += NW) {
        const int mi = u / U.per_m, nt0 = (u - mi * U.per_m) * U.nj;
        const int nj = min(U.nj, P / 8 - nt0);
        seg_mma<false, false>(acc, nj, Qv + j * CHP, qp, mi * 16,
                              staged ? Kt + j * CHP * ktp : kpt(j), ktp,
                              nt0 * 8, CHP, lane);
        store_unit(acc, nj, mi * 16, nt0 * 8, Ss, sp, nullptr, 0, lane);
      }
      __syncthreads();
      softmax_rows(Ss, sp, T, P);
      __syncthreads();
      U = units_of(mt, CHP / 8);
      for (int u = warp; u < U.units; u += NW) {
        const int mi = u / U.per_m, nt0 = (u - mi * U.per_m) * U.nj;
        const int nj = min(U.nj, CHP / 8 - nt0);
        seg_mma<false, true>(acc, nj, Ss, sp, mi * 16,
                             staged ? Vp + j * CHP * vvp : vpg(j), vvp,
                             nt0 * 8, P, lane);
        store_unit(acc, nj, mi * 16, nt0 * 8, Os, op, nullptr, 0, lane);
      }
      __syncthreads();
    }
    const Units U = units_of(mt, CHP / 8);
    for (int u = warp; u < U.units; u += NW) {
      const int mi = u / U.per_m, nt0 = (u - mi * U.per_m) * U.nj;
      output(j, mi, nt0, min(U.nj, CHP / 8 - nt0), Os, mi * 16);
    }
    __syncthreads();  // Ss and Os are free for the next head
  }
}

// ---- launches --------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  done = e == cudaSuccess;
  return e;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// the build's form of the token operands (dsa.cu's form_ok)
bool form_ok(const float* pe, const float* lns, const float* lnb,
             bool has_gamma) {
  if (FUSED) return lns != nullptr && lnb != nullptr && has_gamma;
  return pe == nullptr && lns == nullptr && lnb == nullptr && !has_gamma;
}

// dsa.cu's widths (kernels/dsa_attention.py::supported), and a token tile
// of 16, 32, 64 or 128
bool supported(int C, int P, int heads, int T, int mode) {
  if (heads <= 0 || C % heads || mode < PARALLEL || mode > CHANNEL)
    return false;
  if ((P == 0) != (mode == CHANNEL)) return false;
  const int ch = C / heads;
  return pow2(ch) && ch >= 2 && ch <= 128 &&
         (P == 0 || P == 16 || P == 32 || P == 64 || P == 128) && C >= 8 &&
         C <= 512 && pow2(C) && pow2(T) && T >= 16 && T <= 128;
}

Tok tokens(const float* x, const float* pe, const float* lns,
           const float* lnb, const float* w, int mode, int N, int C,
           int heads, int T, float eps) {
  Tok t;
  t.nslot = mode == PARALLEL ? 4 : 3;
  t.x = x;
  t.pe = pe;
  t.lns = lns;
  t.lnb = lnb;
  t.w = w;
  t.N = N;
  t.C = C;
  t.heads = heads;
  t.T = T;
  t.eps = eps;
  return t;
}

}  // namespace

// phase A and its finishing pass (dsa.cu's fcd_dsa_phase_a, every tensor
// f32). part: (chunks, B, heads, F) f32 scratch; glue 0: o0..o4 = qk, q2,
// k2, kp, vp; glue 1: o0..o3 = qnorm, abig, kpt, vp, t1/t2 the (heads,)
// temperatures. ef is null in mode 3 (P = 0). groups: the column groups a
// head's phase A blocks split into (1, or a power of two up to CH / 8).
extern "C" int fcd_dsa_f32_phase_a(const float* x, const float* pe,
                                   const float* lns, const float* lnb,
                                   const float* w, int mode, const float* ef,
                                   float* part, int glue, const float* t1,
                                   const float* t2, float* o0, float* o1,
                                   float* o2, float* o3, float* o4, int B,
                                   int N, int C, int P, int heads, int T,
                                   int per_chunk, int chunks, int groups,
                                   float eps, void* stream) {
  if (!supported(C, P, heads, T, mode) || per_chunk < 1 || chunks < 1 ||
      N < 1 || B < 1 || !pow2(groups) || !form_ok(pe, lns, lnb, FUSED))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + T - 1) / T;
  if ((long long)chunks * per_chunk < tiles ||
      (long long)(chunks - 1) * per_chunk >= tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CH = C / heads;
  if (groups > 1 && CH / groups < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_a(C, CH, P, T, groups);
  if (bytes > SMEM_CAP || !projects(T, cols_a(padded(CH), groups, P)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool ready = false, finish_ready = false;
  cudaError_t e = allow_smem(dsa_f32_phase_a_kernel, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(dsa_f32_phase_a_finish, finish_ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  ParamsA pa;
  pa.tk = tokens(x, pe, lns, lnb, w, mode, N, C, heads, T, eps);
  pa.mode = mode;
  pa.ef = ef;
  pa.P = P;
  pa.part = part;
  pa.tiles = tiles;
  pa.per_chunk = per_chunk;
  pa.G = groups;
  dsa_f32_phase_a_kernel<<<dim3(chunks, heads * groups, B), NT, bytes, s>>>(
      pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ParamsF pf;
  pf.part = part;
  pf.chunks = chunks;
  pf.heads = heads;
  pf.C = C;
  pf.CH = CH;
  pf.P = P;
  pf.rb = finish_rows(CH);
  pf.glue = glue;
  pf.t1 = t1;
  pf.t2 = t2;
  pf.qk = pf.q2 = pf.k2 = pf.kp = pf.vp = nullptr;
  pf.qnorm = pf.abig = pf.kpt = pf.vpb = nullptr;
  if (glue) {
    pf.qnorm = o0;
    pf.abig = o1;
    pf.kpt = o2;
    pf.vpb = o3;
  } else {
    pf.qk = o0;
    pf.q2 = o1;
    pf.k2 = o2;
    pf.kp = o3;
    pf.vp = o4;
  }
  const int rb = pf.rb, row_blocks = CH / rb;
  const int kv_blocks = (2 * CH * P + FT - 1) / FT;
  dsa_f32_phase_a_finish<<<dim3(row_blocks + kv_blocks, heads, B), FT,
                           (rb * CH + 2 * rb + 2 * CH) * sizeof(float), s>>>(
      pf);
  return static_cast<int>(cudaGetLastError());
}

// phase B (dsa.cu's fcd_dsa_phase_b, every tensor f32); hb heads a block
// (1, 2 or 4, dividing heads)
extern "C" int fcd_dsa_f32_phase_b(const float* x, const float* pe,
                                   const float* lns, const float* lnb,
                                   const float* w, int mode,
                                   const float* qnorm, const float* abig,
                                   const float* kpt, const float* vp,
                                   const float* gamma, float* out, int B,
                                   int N, int C, int P, int heads, int T,
                                   int hb, float eps, void* stream) {
  if (!supported(C, P, heads, T, mode) || N < 1 || B < 1 || !pow2(hb) ||
      hb > MAX_HB || heads % hb || !form_ok(pe, lns, lnb, gamma != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int CH = C / heads;
  const int bytes = smem_b(C, CH, P, T, hb);
  if (bytes > SMEM_CAP || !projects(T, 2 * hb * padded(CH)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  cudaError_t e = allow_smem(dsa_f32_phase_b_kernel, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  ParamsB pb;
  pb.tk = tokens(x, pe, lns, lnb, w, mode, N, C, heads, T, eps);
  pb.mode = mode;
  pb.P = P;
  pb.qnorm = qnorm;
  pb.abig = abig;
  pb.kpt = kpt;
  pb.vp = vp;
  pb.gamma = gamma;
  pb.out = out;
  pb.HB = hb;
  const int tiles = (N + T - 1) / T;
  dsa_f32_phase_b_kernel<<<dim3(tiles, heads / hb, B), NT, bytes,
                           static_cast<cudaStream_t>(stream)>>>(pb);
  return static_cast<int>(cudaGetLastError());
}
