// B5 in f32: the fused eval dual self-attention (every sa_type) for a
// model that computes in f32, on the CUDA cores (Hopper, sm_90a): phase
// A, its finishing pass, phase B. Three launches a call.
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
// EF, pos-embed and the outputs are f32 (IEEE: every product is an f32
// fused multiply-add on the CUDA cores; no tensor-core instruction, so no
// TF32).
//
// What bounds it (H100: 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): per
// token each phase reads ~8C bytes and does ~6C^2 + 4CP operations, 40-400
// operations a byte at the levels' widths, above the card's ~20 for f32:
// the operations, where they fill the card. The design is the simple one
// (a later PR may take the products to the tensor cores, 3xTF32):
//   * The grid is dsa.cu's: (token chunk or tile, head, batch), the tiles
//     and chunks from kernels/dsa_attention.py::dsa_plan_f32 (pure
//     Python). A block LayerNorms its tile's full token rows into shared
//     memory (a warp a token), projects its head's columns (a thread an
//     output, the weights read through the L1 cache), then sums (phase A)
//     or attends (phase B) over the tile.
//   * Phase A's sums are fixed per thread: thread i owns the record values
//     i, i + 256, ...; each tile's sum over its tokens, in token order, is
//     added to the chunk's record in device memory by the thread that owns
//     it (read, add, write: no other thread touches it). The finishing
//     pass adds the chunks' records in chunk order, as dsa.cu's does, and
//     writes phase B's operands in f32. No atomics: two calls give the
//     same bits.
//   * Phase B's products read qnorm, abig, kpt and vp through the L1
//     cache; the softmax over P is a warp a token.
// Widths: every (C, P, heads) that dsa.cu takes (head width 2-128, P 0 or
// 16-128, C a power of two from 8 to 512): the loops run over the widths
// at run time, so one instance of each kernel serves them all.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of a phase A or B block
constexpr int NW = NT / 32;
constexpr int FT = 1024;           // threads of a finishing-pass block
constexpr int SMEM_CAP = 232448;   // shared memory one block may hold
constexpr float L2_EPS = 1e-12f;   // fcd_tpu/ops/attention.py::_l2_normalize

enum Mode { PARALLEL = 0, SERIAL = 1, SPATIAL = 2, CHANNEL = 3 };

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

// the tile's T token rows from token n0 of batch item b, LayerNormed, into
// Xs (T x C), rows past N zero; with Bs, t = x + pe of the head's channels
// c0 .. c0 + CH into Bs (T x CH). A warp a token, var = E[t^2] - mean^2
// clamped at 0, as ops/layers.py::layer_norm computes it.
__device__ void ln_tile(const Tok& tk, int b, int n0, float* Xs, float* Bs,
                        int c0, int CH) {
  const int C = tk.C, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < tk.T; t += NW) {
    const int n = n0 + t;
    float* row = Xs + (size_t)t * C;
    if (n >= tk.N) {
      for (int c = lane; c < C; c += 32) row[c] = 0.f;
      if (Bs != nullptr)
        for (int c = lane; c < CH; c += 32) Bs[t * CH + c] = 0.f;
      continue;
    }
    const float* xr = tk.x + ((size_t)b * tk.N + n) * C;
    const float* pr = tk.pe == nullptr ? nullptr : tk.pe + (size_t)n * C;
    float s = 0.f, q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xr[c] + (pr != nullptr ? pr[c] : 0.f);
      row[c] = v;
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mu = s / C;
    const float rstd = rsqrtf(fmaxf(q / C - mu * mu, 0.f) + tk.eps);
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      const float v = row[c];
      if (Bs != nullptr && c >= c0 && c < c0 + CH) Bs[t * CH + c - c0] = v;
      row[c] = (v - mu) * rstd * tk.lns[c] + tk.lnb[c];
    }
  }
}

// out[t][j] = sum_c Xs[t][c] w[c][slot C + c0 + j] for the slots of `slots`
// (slot s_i's output into outs[i], T x CH each), a thread an output,
// consecutive threads on consecutive j
__device__ void project(const Tok& tk, const float* Xs, int c0, int CH,
                        const int* slots, int ns, float* const* outs) {
  const int C = tk.C, ld = tk.nslot * C;
  const int per = tk.T * CH;
  for (int i = threadIdx.x; i < ns * per; i += NT) {
    const int si = i / per, r = i - si * per;
    const int t = r / CH, j = r - t * CH;
    const float* xr = Xs + (size_t)t * C;
    const float* wc = tk.w + slots[si] * C + c0 + j;
    float a0 = 0.f, a1 = 0.f;
    int c = 0;
    for (; c + 1 < C; c += 2) {
      a0 = fmaf(xr[c], __ldg(wc + (size_t)c * ld), a0);
      a1 = fmaf(xr[c + 1], __ldg(wc + (size_t)(c + 1) * ld), a1);
    }
    if (c < C) a0 = fmaf(xr[c], __ldg(wc + (size_t)c * ld), a0);
    outs[si][r] = a0 + a1;
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
};

// Xs (T x C), q | k | v_sa (T x CH each), the ef tile (T x P)
__host__ __device__ inline int smem_a(int C, int CH, int P, int T) {
  return 4 * (T * C + 3 * T * CH + T * P);
}

// grid (chunk, head, batch): the chunk's token tiles, head h's columns; the
// record [qk (CH x CH) | q2 | k2 (CH) | kp (CH x P) | vp (CH x P)]
__global__ void __launch_bounds__(NT) dsa_f32_phase_a_kernel(
    const ParamsA p) {
  extern __shared__ __align__(16) float sm[];
  const Tok& tk = p.tk;
  const int C = tk.C, T = tk.T, P = p.P, CH = C / tk.heads;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = h * CH;
  float* Xs = sm;
  float* Qs = Xs + T * C;
  float* Ks = Qs + T * CH;
  float* Vs = Ks + T * CH;
  float* Es = Vs + T * CH;
  const int NO = CH * CH + 2 * CH, F = NO + 2 * CH * P;
  float* rec = p.part + (((size_t)chunk * gridDim.z + b) * gridDim.y + h) * F;
  const int slots[3] = {0, 1, p.mode == PARALLEL ? 3 : 2};
  float* outs[3] = {Qs, Ks, Vs};
  const int ns = P > 0 ? 3 : 2;
  const int t0 = chunk * p.per_chunk;
  const int t1 = min(t0 + p.per_chunk, p.tiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * T;
    __syncthreads();  // the last tile's sums are done with the tile
    ln_tile(tk, b, n0, Xs, nullptr, 0, CH);
    for (int i = threadIdx.x; i < T * P; i += NT) {
      const int t = i / P, q = i - t * P;
      Es[i] = n0 + t < tk.N ? p.ef[(size_t)(n0 + t) * P + q] : 0.f;
    }
    __syncthreads();
    project(tk, Xs, c0, CH, slots, ns, outs);
    __syncthreads();
    // the tile's sum of each record value this thread owns, in token
    // order, added to the chunk's record
    for (int f = threadIdx.x; f < F; f += NT) {
      const float *ua, *ub;
      int sa, sb;  // strides of the two factors along the tokens
      if (f < CH * CH) {
        ua = Qs + f / CH, ub = Ks + f % CH, sa = sb = CH;
      } else if (f < CH * CH + CH) {
        ua = ub = Qs + (f - CH * CH), sa = sb = CH;
      } else if (f < NO) {
        ua = ub = Ks + (f - CH * CH - CH), sa = sb = CH;
      } else {
        const int g = f - NO, half = g / (CH * P), r = g - half * CH * P;
        ua = (half ? Vs : Ks) + r / P, sa = CH;
        ub = Es + r % P, sb = P;
      }
      float s = 0.f;
      for (int t = 0; t < T; ++t) s = fmaf(ua[t * sa], ub[t * sb], s);
      rec[f] = tile == t0 ? s : rec[f] + s;
    }
  }
}

struct ParamsF {
  const float* part;
  int chunks, heads, C, CH, P;
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

// grid (1 + kv blocks, head, batch), FT threads (dsa.cu's
// dsa_phase_a_finish, f32 out): block 0 adds qk, q2 and k2 and (glue) does
// the glue; the others add FT values each of kp | vp
__global__ void __launch_bounds__(FT) dsa_f32_phase_a_finish(
    const ParamsF p) {
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
      (is_vp ? p.vpb : p.kpt)[i] = is_vp ? s : s * p.t2[h];
    return;
  }
  extern __shared__ float fs[];  // NO sums, then qnorm and knorm (2 CH)
  for (int f = threadIdx.x; f < NO; f += FT) {
    const float s = chunk_sum(src + f, stride, p.chunks);
    fs[f] = s;
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
  float* qn = fs + NO;
  float* kn = qn + CH;
  for (int c = threadIdx.x; c < CH; c += FT) {
    qn[c] = rsqrtf(fs[CH * CH + c] + L2_EPS);
    kn[c] = rsqrtf(fs[CH * CH + CH + c] + L2_EPS);
    p.qnorm[row + c] = qn[c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float t1 = p.t1[h];
  float* ab = p.abig + ((size_t)b * p.heads + h) * CH * CH;
  for (int r = warp; r < CH; r += FT / 32) {
    float v[SOFTMAX_COLS], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SOFTMAX_COLS; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < CH ? fs[r * CH + c] * qn[r] * kn[c] * t1 : -INFINITY;
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
      if (c < CH) ab[c * CH + r] = v[i] / sum;
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
};

// Xs (T x C), t (T x CH), qn | v | the spatial output (T x CH each), s
// (T x P)
__host__ __device__ inline int smem_b(int C, int CH, int P, int T) {
  return 4 * (T * C + 4 * T * CH + T * P);
}

// o[t][c] = sum_d a[t][d] m[d][c] (a T x CH in shared memory, m CH x CH)
__device__ __forceinline__ float head_product(const float* a, const float* m,
                                              int t, int c, int CH) {
  float s = 0.f;
  for (int d = 0; d < CH; ++d) s = fmaf(a[t * CH + d], __ldg(m + d * CH + c), s);
  return s;
}

// grid (tile, head, batch)
__global__ void __launch_bounds__(NT) dsa_f32_phase_b_kernel(
    const ParamsB p) {
  extern __shared__ __align__(16) float sm[];
  const Tok& tk = p.tk;
  const int C = tk.C, T = tk.T, P = p.P, CH = C / tk.heads;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = h * CH, n0 = tile * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* Xs = sm;
  float* Bs = Xs + T * C;
  float* Qs = Bs + T * CH;
  float* Vs = Qs + T * CH;
  float* Os = Vs + T * CH;  // the spatial output
  float* Ss = Os + T * CH;
  ln_tile(tk, b, n0, Xs, Bs, c0, CH);
  __syncthreads();
  const int slots[2] = {0, 2};  // q, and v_ca (or v)
  float* outs[2] = {Qs, Vs};
  project(tk, Xs, c0, CH, slots, 2, outs);
  __syncthreads();
  const float* qnorm = p.qnorm + (size_t)b * C + c0;
  const float* ab = p.abig + ((size_t)b * tk.heads + h) * CH * CH;
  const bool spatial = p.mode != CHANNEL;
  if (spatial) {
    const float* kpt = p.kpt + ((size_t)b * C + c0) * P;
    const float* vp = p.vp + ((size_t)b * C + c0) * P;
    for (int i = threadIdx.x; i < T * CH; i += NT)
      Qs[i] *= qnorm[i % CH];
    __syncthreads();
    // scores s[t][q] = sum_j qn[t][j] kpt[j][q]
    for (int i = threadIdx.x; i < T * P; i += NT) {
      const int t = i / P, q = i - t * P;
      float s = 0.f;
      for (int j = 0; j < CH; ++j)
        s = fmaf(Qs[t * CH + j], __ldg(kpt + (size_t)j * P + q), s);
      Ss[i] = s;
    }
    __syncthreads();
    // the softmax over P, a warp a token
    for (int t = warp; t < T; t += NW) {
      float* row = Ss + t * P;
      float mx = -INFINITY;
      for (int q = lane; q < P; q += 32) mx = fmaxf(mx, row[q]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int q = lane; q < P; q += 32) {
        const float e = expf(row[q] - mx);
        row[q] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();
      for (int q = lane; q < P; q += 32) row[q] /= sum;
    }
    __syncthreads();
    // the spatial output out_sa[t][j] = sum_q s[t][q] vp[j][q]
    for (int i = threadIdx.x; i < T * CH; i += NT) {
      const int t = i / CH, j = i - t * CH;
      const float* vr = vp + (size_t)j * P;
      float s = 0.f;
      for (int q = 0; q < P; ++q) s = fmaf(Ss[t * P + q], __ldg(vr + q), s);
      Os[i] = s;
    }
    __syncthreads();
  }
  // y = t + gamma * out: out_ca (+ out_sa), out_sa alone, or out_sa abig
  for (int i = threadIdx.x; i < T * CH; i += NT) {
    const int t = i / CH, c = i - t * CH;
    if (n0 + t >= tk.N) continue;
    float o;
    if (p.mode == SERIAL)
      o = head_product(Os, ab, t, c, CH);
    else if (p.mode == SPATIAL)
      o = Os[i];
    else if (p.mode == CHANNEL)
      o = head_product(Vs, ab, t, c, CH);
    else
      o = head_product(Vs, ab, t, c, CH) + Os[i];
    p.out[((size_t)b * tk.N + n0 + t) * C + c0 + c] =
        Bs[i] + p.gamma[c0 + c] * o;
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

// dsa.cu's widths (kernels/dsa_attention.py::supported), any T from 1
bool supported(int C, int P, int heads, int T, int mode) {
  if (heads <= 0 || C % heads || mode < PARALLEL || mode > CHANNEL || T < 1)
    return false;
  if ((P == 0) != (mode == CHANNEL)) return false;
  const int ch = C / heads;
  return pow2(ch) && ch >= 2 && ch <= 128 &&
         (P == 0 || P == 16 || P == 32 || P == 64 || P == 128) && C >= 8 &&
         C <= 512 && pow2(C);
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
// temperatures. ef is null in mode 3 (P = 0).
extern "C" int fcd_dsa_f32_phase_a(const float* x, const float* pe,
                                   const float* lns, const float* lnb,
                                   const float* w, int mode, const float* ef,
                                   float* part, int glue, const float* t1,
                                   const float* t2, float* o0, float* o1,
                                   float* o2, float* o3, float* o4, int B,
                                   int N, int C, int P, int heads, int T,
                                   int per_chunk, int chunks, float eps,
                                   void* stream) {
  if (!supported(C, P, heads, T, mode) || per_chunk < 1 || chunks < 1 ||
      N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + T - 1) / T;
  if ((long long)chunks * per_chunk < tiles ||
      (long long)(chunks - 1) * per_chunk >= tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CH = C / heads;
  const int bytes = smem_a(C, CH, P, T);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
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
  dsa_f32_phase_a_kernel<<<dim3(chunks, heads, B), NT, bytes, s>>>(pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ParamsF pf;
  pf.part = part;
  pf.chunks = chunks;
  pf.heads = heads;
  pf.C = C;
  pf.CH = CH;
  pf.P = P;
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
  const int NO = CH * CH + 2 * CH;
  const int kv_blocks = (2 * CH * P + FT - 1) / FT;
  dsa_f32_phase_a_finish<<<dim3(1 + kv_blocks, heads, B), FT,
                           (NO + 2 * CH) * sizeof(float), s>>>(pf);
  return static_cast<int>(cudaGetLastError());
}

// phase B (dsa.cu's fcd_dsa_phase_b, every tensor f32)
extern "C" int fcd_dsa_f32_phase_b(const float* x, const float* pe,
                                   const float* lns, const float* lnb,
                                   const float* w, int mode,
                                   const float* qnorm, const float* abig,
                                   const float* kpt, const float* vp,
                                   const float* gamma, float* out, int B,
                                   int N, int C, int P, int heads, int T,
                                   float eps, void* stream) {
  if (!supported(C, P, heads, T, mode) || N < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_b(C, C / heads, P, T);
  if (bytes > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
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
  const int tiles = (N + T - 1) / T;
  dsa_f32_phase_b_kernel<<<dim3(tiles, heads, B), NT, bytes,
                           static_cast<cudaStream_t>(stream)>>>(pb);
  return static_cast<int>(cudaGetLastError());
}
