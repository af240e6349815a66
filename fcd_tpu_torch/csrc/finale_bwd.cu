// K2: the train finale's backward, writing both input gradients (Hopper,
// sm_90a).
//
// Replaces fcd_tpu/kernels/finale.py::finale_bwd_pallas (:170, pallas_call
// :207) and the PyTorch passes Finale.backward ran after it (the two
// scalings of dt and their casts, the sum over per-program partials). Per
// (b, voxel, c), with ys, rs and gp bf16 (B, D, H, W, C), the affines f32
// (B, C) and gq, the pooled output's cotangent, bf16 (B, D/2, H/2, W/2, C):
//
//   t    = (ys * s2 + b2) + (rs * sr + br)                          f32
//   g    = gp + share                                               f32
//   dt   = g * (t >= 0 ? 1 : slope)                                 f32
//   d_ys = bf16(bf16(dt) * s2),   d_rs = bf16(bf16(dt) * sr)
//   a1   = sum dt * ys,   a2 = sum dt,   a3 = sum dt * rs          per (b, c)
//
// share is the child's part of gq at its pooled voxel when the block pools,
// taken on the bf16-rounded output bf16(t >= 0 ? t : slope * t): EVEN
// (levels 1-2) gives gq / ties to each child equal to the 2x2x2 maximum and
// 0 to the others; CHAIN (levels 3-5) gives gq times the child's factors of
// the jnp.maximum chain over W, then D, then H pairs (0 off a pair's
// maximum, 1/2 on a tie, 1 otherwise). NO_POOL takes g = gp.
//
// Every multiply and add of t, g, dt and the two scalings is __fmul_rn /
// __fadd_rn (nothing is contracted into an fma), the tie share is an IEEE
// division and every rounding is cvt.rn.bf16x2: d_ys and d_rs are the plain
// version's bits for any f32 affines. Only the sums a1..a3 take another
// order.
//
// What bounds it: bytes. Per element it reads ys, rs and gp (6 bytes) and
// writes d_ys and d_rs (4), plus 2/8 of a byte of gq when pooled, against
// ~30 operations; at 3.35 TB/s the card moves ~330 G elements a second and
// its CUDA cores issue ~90 instructions an element in that time. So the
// design keeps the bytes at that minimum and many of them in flight:
//
// - A thread owns V channels of two voxels without the pool, or one
//   channel of a pooled voxel's eight children, and issues all its loads
//   (3 x 8 + 1 with the pool) before it uses any; it takes the maximum, the
//   tie count or the chain factors in registers and stores d_ys and d_rs
//   with the width it read. Neighbouring threads take neighbouring channel
//   groups, then neighbouring (pooled) voxels along x, so a warp's access
//   to one child is one run of whole sectors.
// - V = 8 (one 16-byte access of each tensor) without the pool: ~107
//   registers, two blocks of 256 an SM. With the pool, 8 children x 3
//   tensors x 16 bytes is 96 registers of loads alone: V = 8 took 255
//   registers and one block an SM (and spilled in the even mode), and lost
//   to one channel a thread (2-byte accesses, 64 registers, four blocks an
//   SM: 0.5647 against 0.6241 ms at enc1 on an H100, PERF.md), so the pool
//   takes V = 1 only. So does any C % 8 != 0, and a call too small for
//   V = 8 to fill the SMs (8^3 and 4^3 in the train step), where V = 1
//   gives eight times the blocks.
// - A block walks many tiles of T units of one batch item (a unit: one
//   pooled voxel's children, or one voxel, x V channels). T is a multiple
//   of C / V, so a thread's channels are the same on every tile and it
//   carries its 3 x V partial sums in registers across the walk. The
//   block's affines are staged once in shared memory, interleaved so that
//   one 16-byte read gives a channel's four.
// - No atomics (ROADMAP C9). At the end of its walk a block adds its
//   threads' partials in a fixed tree (warp shuffles, then shared memory)
//   and writes one (3, C) row; finale_bwd_finish adds the rows in block
//   order. A call is these two kernels, and two calls give the same bits.
//
// The plan (V, T, the tiles of each block, the grid) is
// kernels/finale.py::finale_bwd_plan; this file computes none of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { NO_POOL = 0, EVEN = 1, CHAIN = 2 };

struct Args {
  const uint16_t* ys;
  const uint16_t* rs;
  const uint16_t* gp;
  const uint16_t* gq;
  const float* aff[4];     // s2, b2, sr, br: (B, C), channel stride 1
  int64_t aff_stride[4];   // their batch strides (0 where expanded)
  uint16_t* dys;
  uint16_t* drs;
  float* part;             // (B x blocks, 3, C): one row a block
  int D, H, W, C;
  int groups;              // C / V
  int units;               // a batch item's units
  int tiles;               // a batch item's tiles
  int blocks;              // a batch item's blocks (gridDim.x)
  float slope;
};

// bf16 <-> f32 on raw bits: a bf16 value is the top half of an f32
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// two f32 rounded to nearest even into one bf16x2 word, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// V bf16 values as N = V / 2 words of NC = 2 channels (V = 1: one word,
// its value in the low half)
template <int V>
struct Pack {
  static constexpr int N = V > 1 ? V / 2 : 1;
  static constexpr int NC = V > 1 ? 2 : 1;
  uint32_t w[N];
  __device__ __forceinline__ float get(int j) const {
    if (V == 1) return lo_f(w[0]);
    return (j & 1) ? hi_f(w[j >> 1]) : lo_f(w[j >> 1]);
  }
};

template <int V>
__device__ __forceinline__ void load(Pack<V>& r, const uint16_t* p, bool ok) {
  if constexpr (V == 8) {
    const uint4 v =
        ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else {
    r.w[0] = ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
  }
}

template <int V>
__device__ __forceinline__ void store(uint16_t* p, const Pack<V>& r) {
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  else
    *p = static_cast<uint16_t>(r.w[0]);
}

// channel j's (s2, b2, sr, br) from the block's staged affines
__device__ __forceinline__ float4 affine(const float* sa, int j) {
  return reinterpret_cast<const float4*>(sa)[j];
}

// the preactivation in B2's order, without contraction
__device__ __forceinline__ float preact(float y, float r, float4 a) {
  return __fadd_rn(__fadd_rn(__fmul_rn(y, a.x), a.y),
                   __fadd_rn(__fmul_rn(r, a.z), a.w));
}

// a word of d_ys and of d_rs from NC values of dt: bf16(bf16(dt) * s)
template <int NC>
__device__ __forceinline__ void scale_word(const float (&dt)[2], float4 a0,
                                           float4 a1, uint32_t& oy,
                                           uint32_t& orr) {
  const uint32_t d = pack2(dt[0], NC > 1 ? dt[1] : 0.f);
  const float e0 = lo_f(d), e1 = hi_f(d);
  oy = pack2(__fmul_rn(e0, a0.x), NC > 1 ? __fmul_rn(e1, a1.x) : 0.f);
  orr = pack2(__fmul_rn(e0, a0.z), NC > 1 ? __fmul_rn(e1, a1.z) : 0.f);
}

// one jnp.maximum of the chain: the max, and a's and b's factors
__device__ __forceinline__ void pair(float a, float b, float& m, float& fa,
                                     float& fb) {
  m = fmaxf(a, b);
  const float half = a == b ? 0.5f : 1.f;
  fa = a == m ? half : 0.f;
  fb = b == m ? half : 0.f;
}

// child k = 4 kd + 2 kh + kw: its factor under the W, D, H chain
__device__ __forceinline__ void chain_factors(const float (&f)[8],
                                              float (&fac)[8]) {
  float mw[4], fw[8], md[2], fd[4], fh[2], mh;
#pragma unroll
  for (int p = 0; p < 4; ++p)  // p = 2 kd + kh
    pair(f[2 * p], f[2 * p + 1], mw[p], fw[2 * p], fw[2 * p + 1]);
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
    pair(mw[kh], mw[2 + kh], md[kh], fd[kh], fd[2 + kh]);
  pair(md[0], md[1], mh, fh[0], fh[1]);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    fac[k] = __fmul_rn(__fmul_rn(fw[k], fd[k >> 1]), fh[(k >> 1) & 1]);
}

// Without the pool: units tile * 2T + tid and tile * 2T + T + tid, each one
// voxel x V channels, at element (b units + u) V.
template <int V>
__device__ __forceinline__ void tile_flat(const Args& a, const float* sa,
                                          int b, int tile, int tid, int T,
                                          float (&acc)[3][V]) {
  constexpr int R = 2, NC = Pack<V>::NC;
  Pack<V> y[R], r[R], gr[R];
  int64_t off[R];
  bool ok[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int u = (tile * R + i) * T + tid;
    ok[i] = u < a.units;
    off[i] = ((int64_t)b * a.units + u) * V;
    load<V>(y[i], a.ys + off[i], ok[i]);
    load<V>(r[i], a.rs + off[i], ok[i]);
    load<V>(gr[i], a.gp + off[i], ok[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!ok[i]) continue;
    Pack<V> oy, orr;
#pragma unroll
    for (int w = 0; w < Pack<V>::N; ++w) {
      float dt[2];
      float4 aw[2];
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int j = w * NC + h;
        aw[h] = affine(sa, j);
        const float yf = y[i].get(j), rf = r[i].get(j);
        const float t = preact(yf, rf, aw[h]);
        dt[h] = __fmul_rn(gr[i].get(j), t >= 0.f ? 1.f : a.slope);
        acc[0][j] = fmaf(dt[h], yf, acc[0][j]);
        acc[1][j] += dt[h];
        acc[2][j] = fmaf(dt[h], rf, acc[2][j]);
      }
      scale_word<NC>(dt, aw[0], aw[NC - 1], oy.w[w], orr.w[w]);
    }
    store<V>(a.dys + off[i], oy);
    store<V>(a.drs + off[i], orr);
  }
}

// With the pool: unit tile * T + tid, one pooled voxel's eight children x
// the thread's channel g (one channel a thread: the header says why).
template <int MODE>
__device__ __forceinline__ void tile_pool(const Args& a, const float* sa,
                                          int b, int tile, int tid, int T,
                                          int g, float (&acc)[3][1]) {
  const int u = tile * T + tid;
  const bool ok = u < a.units;
  const int hp = a.H >> 1, wp = a.W >> 1;
  const int pv = ok ? u / a.groups : 0;
  const int px = pv % wp, rest = pv / wp, py = rest % hp, pz = rest / hp;
  const int64_t rowc = (int64_t)a.W * a.C, slabc = rowc * a.H;
  const int64_t base = ((int64_t)b * a.D + 2 * pz) * slabc +
                       (2 * py) * rowc + (2 * px) * (int64_t)a.C + g;
  auto child = [&](int k) {
    return base + (k >> 2) * slabc + ((k >> 1) & 1) * rowc + (k & 1) * a.C;
  };
  Pack<1> y[8], r[8], gr[8], q;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    load<1>(y[k], a.ys + child(k), ok);
    load<1>(r[k], a.rs + child(k), ok);
    load<1>(gr[k], a.gp + child(k), ok);
  }
  const int64_t npool = (int64_t)(a.D >> 1) * hp * wp;
  load<1>(q, a.gq + ((int64_t)b * npool + pv) * a.C + g, ok);
  if (!ok) return;
  const float4 aw = affine(sa, 0);
  // the bf16-rounded outputs, and the preactivations' signs
  float f[8];
  unsigned neg = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t = preact(y[k].get(0), r[k].get(0), aw);
    neg |= (unsigned)(t < 0.f) << k;
    f[k] = lo_f(pack2(t >= 0.f ? t : __fmul_rn(a.slope, t), 0.f));
  }
  float share[8];
  if constexpr (MODE == EVEN) {
    float m = f[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) m = fmaxf(m, f[k]);
    float ties = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) ties += f[k] == m ? 1.f : 0.f;
    const float s = __fdiv_rn(q.get(0), ties);
#pragma unroll
    for (int k = 0; k < 8; ++k) share[k] = f[k] == m ? s : 0.f;
  } else {
    float fac[8];
    chain_factors(f, fac);
#pragma unroll
    for (int k = 0; k < 8; ++k) share[k] = __fmul_rn(q.get(0), fac[k]);
  }
  float dt[8][2], s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float yf = y[k].get(0), rf = r[k].get(0);
    dt[k][0] = __fmul_rn(__fadd_rn(gr[k].get(0), share[k]),
                         (neg >> k) & 1 ? a.slope : 1.f);
    dt[k][1] = 0.f;
    s1 = fmaf(dt[k][0], yf, s1);
    s2 += dt[k][0];
    s3 = fmaf(dt[k][0], rf, s3);
  }
  acc[0][0] += s1;
  acc[1][0] += s2;
  acc[2][0] += s3;
  Pack<1> oy[8], orr[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    scale_word<1>(dt[k], aw, aw, oy[k].w[0], orr[k].w[0]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    store<1>(a.dys + child(k), oy[k]);
    store<1>(a.drs + child(k), orr[k]);
  }
}

// The block's partial sums, from each thread's 3 V slots of red, in a
// fixed tree: where a warp's lanes hold C / V groups that divide 32,
// shuffles first, then shared memory; one (3, C) row at the block's slot.
template <int V>
__device__ __forceinline__ void block_sums(const Args& a, float* red, int tid,
                                           int T) {
  constexpr int S = 3 * V;
  const int G = a.groups;
  int n = T;  // entries; entry e holds group e % G
  if (32 % G == 0 && T % 32 == 0) {
    float v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = red[s * T + tid];
    for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        v[s] += __shfl_xor_sync(0xffffffffu, v[s], off);
    }
    __syncthreads();
    const int lane = tid & 31;
    if (lane < G) {
#pragma unroll
      for (int s = 0; s < S; ++s) red[s * T + (tid >> 5) * G + lane] = v[s];
    }
    n = (T >> 5) * G;
  }
  __syncthreads();
  for (int stride = n >> 1; stride >= G; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int s = 0; s < S; ++s) red[s * T + tid] += red[s * T + tid + stride];
    }
    __syncthreads();
  }
  if (tid < G) {
    float* row = a.part +
                 ((int64_t)blockIdx.y * a.blocks + blockIdx.x) * 3 * a.C +
                 tid * V;
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j) row[s * a.C + j] = red[(s * V + j) * T + tid];
  }
}

// grid (blocks, B); block x of item b walks tiles [x tiles / blocks,
// (x + 1) tiles / blocks)
template <int V, int MODE, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB) finale_bwd_kernel(const Args a) {
  static_assert(MODE == NO_POOL || V == 1, "the pool takes one channel");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* red = smem + 4 * a.C;   // 3 V x T: each thread's sums, the tree
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.y;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    for (int c = tid; c < a.C; c += T)
      smem[c * 4 + k] = a.aff[k][b * a.aff_stride[k] + c];
  __syncthreads();
  const int g = tid % a.groups;
  const float* sa = smem + g * V * 4;
  float acc[3][V];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[s][j] = 0.f;
  const int t0 = (int)((int64_t)blockIdx.x * a.tiles / a.blocks);
  const int t1 = (int)((int64_t)(blockIdx.x + 1) * a.tiles / a.blocks);
  for (int tile = t0; tile < t1; ++tile) {
    if constexpr (MODE == NO_POOL)
      tile_flat<V>(a, sa, b, tile, tid, T, acc);
    else
      tile_pool<MODE>(a, sa, b, tile, tid, T, g, acc);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int j = 0; j < V; ++j) red[(s * V + j) * T + tid] = acc[s][j];
  block_sums<V>(a, red, tid, T);
}

// out (3, B, C): the rows of each item added in block order
__global__ void __launch_bounds__(256)
    finale_bwd_finish(const float* __restrict__ part, float* __restrict__ out,
                      int B, int C, int blocks) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= 3 * B * C) return;
  const int s = i / (B * C), bc = i - s * B * C, b = bc / C, c = bc - b * C;
  const float* p = part + (int64_t)b * blocks * 3 * C + s * C + c;
  float sum = 0.f;
#pragma unroll 8
  for (int x = 0; x < blocks; ++x) sum += p[(int64_t)x * 3 * C];
  out[i] = sum;
}

template <int V, int MODE, int NT, int MINB>
int launch(const Args& a, int B, int T, int smem, cudaStream_t s) {
  auto kernel = finale_bwd_kernel<V, MODE, NT, MINB>;
  if (T > NT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.blocks, B), T, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instances, as kernels/finale.py::BUILT lists them: V = 1 under a
// launch bound of 1024 threads (64 registers) in every mode, V = 8 of two
// blocks of 256 an SM without the pool
template <int MODE>
int launch_mode(const Args& a, int B, int vec, int T, int smem,
                cudaStream_t s) {
  if (vec == 1) return launch<1, MODE, 1024, 1>(a, B, T, smem, s);
  if constexpr (MODE == NO_POOL)
    if (vec == 8) return launch<8, NO_POOL, 256, 2>(a, B, T, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode: 0 no pool, 1 even, 2 chain; vec, threads, units, tiles, blocks
// and smem from kernels/finale.py::finale_bwd_plan. part: (B x
// blocks, 3, C) f32 scratch; out: (3, B, C) f32.
extern "C" int fcd_finale_bwd(const void* ys, const void* rs, const void* gp,
                              const void* gq, const void* s2, const void* b2,
                              const void* sr, const void* br, int64_t st_s2,
                              int64_t st_b2, int64_t st_sr, int64_t st_br,
                              void* dys, void* drs, void* part, void* out,
                              int B, int D, int H, int W, int C, int mode,
                              int vec, int threads, int units, int tiles,
                              int blocks, int smem, float slope,
                              void* stream) {
  Args a;
  a.ys = static_cast<const uint16_t*>(ys);
  a.rs = static_cast<const uint16_t*>(rs);
  a.gp = static_cast<const uint16_t*>(gp);
  a.gq = static_cast<const uint16_t*>(gq);
  a.aff[0] = static_cast<const float*>(s2);
  a.aff[1] = static_cast<const float*>(b2);
  a.aff[2] = static_cast<const float*>(sr);
  a.aff[3] = static_cast<const float*>(br);
  a.aff_stride[0] = st_s2;
  a.aff_stride[1] = st_b2;
  a.aff_stride[2] = st_sr;
  a.aff_stride[3] = st_br;
  a.dys = static_cast<uint16_t*>(dys);
  a.drs = static_cast<uint16_t*>(drs);
  a.part = static_cast<float*>(part);
  a.D = D;
  a.H = H;
  a.W = W;
  a.C = C;
  a.groups = C / vec;
  a.units = units;
  a.tiles = tiles;
  a.blocks = blocks;
  a.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (mode == NO_POOL)
    err = launch_mode<NO_POOL>(a, B, vec, threads, smem, s);
  else if (mode == EVEN)
    err = launch_mode<EVEN>(a, B, vec, threads, smem, s);
  else if (mode == CHAIN)
    err = launch_mode<CHAIN>(a, B, vec, threads, smem, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int n = 3 * B * C;
  finale_bwd_finish<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, C,
      blocks);
  return static_cast<int>(cudaGetLastError());
}
