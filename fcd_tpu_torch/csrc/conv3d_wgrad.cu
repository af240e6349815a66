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
// B1's prologue (conv3d.cu), with B1's arithmetic (one fma), so that the
// gradient is taken of the very values the forward's conv multiplied.
// Inputs bf16, f32 accumulation, f32 output (27, ci, co).
//
// Design: per tap a GEMM whose reduction axis K is the voxels, rows the
// output channels co and columns the input channels ci, on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulators in registers).
//   * A block owns a (ci tile) x (co tile) of dW for all 27 taps and a
//     chunk of the 4 x 8 x 8 voxel tiles of the (b, z, y, x) grid: chunk c
//     of C takes tiles c, c + C, c + 2C, ..., so the blocks sweep the volume
//     side by side and a tile's halo is mostly in L2, just loaded by the
//     neighbours' blocks (kernels/conv_wgrad.py::wgrad_plan picks C).
//     For each voxel tile it stages, once, the tile's g (the A operand,
//     shared by all 27 taps) and the (6 x 10 x 10) halo brick of x with
//     the prologue applied once per staged value; positions outside the
//     volume stay 0 after the prologue (pro(0) != 0). Both are copied by
//     cp.async in 16-byte vectors (zero-filled outside the volume) into a
//     ring of two stages, so the next tile loads while this one multiplies.
//   * Layout: 8-channel planes of 16-byte voxels, x fastest, so the 8 rows
//     of an ldmatrix are 128 contiguous bytes (no bank conflict), and a
//     tap's shifted B operand is the same ldmatrix with its row addresses
//     moved by the tap's offset into the one brick: nothing is re-read from
//     device memory per tap (the CUDA-core version it replaces read x and g
//     once per tap and per channel tile, ~27x).
//   * Nine warps, one per (dz, dy); a warp's three taps differ in dx, and it
//     keeps their 3 x (co tile / 16) x (ci tile / 8) accumulator tiles in
//     registers over the whole chunk (24 f32 a thread at 16 x 16, 96 at
//     32 x 32). A k-step is 16 voxels (two y-rows of 8): one ldmatrix.x4.trans
//     of g per 16 co, reused by the three taps, and one of x per tap and 16
//     ci. k-steps wholly outside the volume are skipped (the 4^3 grids).
//   * Why mma.sync in every regime: at co = 16-32 (the 128^3 and 64^3
//     launches, most of a step's K1 time) a 64-row wgmma would waste 2-4x
//     of its accumulators and 27 taps of them do not fit in a warpgroup's
//     registers; at co >= 64 (levels 3-6) the products are a few GFLOP a
//     launch and the bound is the dW write, so one code path serves all.
//   * C not a multiple of 8 (the image's C = 2, ragged test widths): a
//     second loader reads the real channels one by one and writes whole
//     zero-padded 16-byte vectors (prologue applied there); the ci tile is
//     then 8 wide, so C = 2 wastes 4x of the products, not 8x.
//
// Fixed-order reduction (no atomics): every block writes its partial dW
// tile once, at its chunk's slot of a (chunks, 27, ci, co) scratch buffer
// that the wrapper allocates with torch.empty (with one chunk the block
// writes dW itself); a second kernel of this file, wgrad_sum_kernel, adds
// the partials: eight runs of consecutive chunks, each summed in chunk
// order, then the eight run sums in order. So dW is the same bits from run
// to run. The wrapper counts one launch per call, both kernels included.
//
// What bounds each regime (H100: 989 TFLOP/s bf16, 3.35 TB/s), and what
// holds the kernel back (kernels/wgrad_sweep.py times it with its prologue
// pass or its products switched off; numbers in PERF.md):
//   * 128^3 and 64^3 at 2-32 channels: the bytes of x and g (enc1.conv2 at
//     4 x 128^3, 16 -> 16: 537 MB, 0.160 ms, against 116 GFLOP, 0.117 ms).
//     Inputs cross device memory once per tile plus the x halo (2.3x, most
//     of it from L2); chunks fill the SMs (one wave of resident blocks).
//     Held back by the loads (each block keeps one tile in flight) and by
//     mma.sync's issue rate, which overlap only in part; shared memory
//     feeds ldmatrix at 256 bytes per mma at 16 x 16, 170 at 32 x 32.
//   * 16^3-8^3: few voxel tiles per dW tile; the plan splits them into
//     chunks while the partials stay under 16 MiB.
//   * 4^3 and the widest 8^3 convs at 256-512 channels: the dW write
//     (27 x 512 x 512 f32 = 28 MB at enc6.conv2) and too few voxels (256) to
//     split: one chunk, the output tiled over the blocks instead, each
//     writing its tile once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 4, TH = 8, TW = 8;                    // voxel tile
constexpr int BD = TD + 2, BH = TH + 2, BW = TW + 2;     // its halo brick
constexpr int TILE = TD * TH * TW;                       // 256 voxels
constexpr int BRICK = BD * BH * BW;                      // 600 positions
// plane pitches, one 16-byte slot over a whole number of 128-byte rows, so
// that the two planes of a voxel, stored by neighbouring threads, fall in
// different banks
constexpr int XPLANE = BRICK * 16 + 16;
constexpr int GPLANE = TILE * 16 + 16;
constexpr int NWARP = 9;                                 // one per (dz, dy)
constexpr int NT = 32 * NWARP;
constexpr int KSTEPS = TD * TH / 2;                      // 16 voxels each
constexpr int SEG = 8;                                   // second-pass runs

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* x;          // (B, D, H, W, ci)
  const bf16* g;          // (B, D, H, W, co)
  const float* in_scale;  // (B, ci) prologue, or null
  const float* in_shift;
  float slope;
  float* out;             // (chunks, 27, ci, co) partials; dW with 1 chunk
  int D, H, W, ci, co;
  int ntz, nty, ntx;      // voxel tiles per batch item
  int tiles;              // B * ntz * nty * ntx
  int nco;                // co tiles
  int vec_x, vec_g;       // 16-byte loads (C % 8 == 0, 16-byte aligned)
};

struct Tile {
  int b, z0, y0, x0;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile r;
  r.x0 = (t % p.ntx) * TW;
  t /= p.ntx;
  r.y0 = (t % p.nty) * TH;
  t /= p.nty;
  r.z0 = (t % p.ntz) * TD;
  r.b = t / p.ntz;
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte cp.async; src_size 0 writes 16 zero bytes (the conv's padding)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B1's prologue arithmetic (conv3d.cu): the forward's conv2 multiplies
// these very values, so its weight gradient sees the same bits
__device__ __forceinline__ float prologue(float v, float sc, float sh,
                                          float slope) {
  v = fmaf(v, sc, sh);
  v = v >= 0.f ? v : slope * v;
  return __bfloat162float(__float2bfloat16(v));
}

// voxel index of (z, y, x) of batch item b, or -1 outside the volume (the
// wrapper holds B * D * H * W under 2^31)
__device__ __forceinline__ int voxel(const Params& p, int b, int z, int y,
                                     int x) {
  return (unsigned)z < (unsigned)p.D && (unsigned)y < (unsigned)p.H &&
                 (unsigned)x < (unsigned)p.W
             ? ((b * p.D + z) * p.H + y) * p.W + x
             : -1;
}

// brick position pos of the tile -> its voxel index, or -1 outside
__device__ __forceinline__ int brick_voxel(const Params& p, const Tile& tl,
                                           int pos) {
  return voxel(p, tl.b, tl.z0 - 1 + pos / (BH * BW),
               tl.y0 - 1 + (pos / BW) % BH, tl.x0 - 1 + pos % BW);
}

// one 16-byte vector of channels c0..c0+7 of voxel v (-1: zeros), built
// from the real channels; the prologue (if any) applied to them
__device__ __forceinline__ uint4 gather8(const bf16* src, int v, int C,
                                         int c0, const float* sc,
                                         const float* sh, float slope) {
  uint4 out = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&out);
  if (v < 0) return out;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    if (c >= C) break;
    float f = __bfloat162float(src[(size_t)v * C + c]);
    if (sc != nullptr) f = prologue(f, sc[c], sh[c], slope);
    e[j] = __float2bfloat16(f);
  }
  return out;
}

// Shared-memory stage and per-thread load slots. NT is a multiple of 4, so
// a thread always takes the same plane (8 channels) of its slots.
template <int MI, int NI>
struct Stage {
  static constexpr int X_BYTES = NI * XPLANE;
  static constexpr int BYTES = X_BYTES + 2 * MI * GPLANE;
  static constexpr int XSLOTS = (NI * BRICK + NT - 1) / NT;
  static constexpr int GSLOTS = (2 * MI * TILE + NT - 1) / NT;
};

// stage voxel tile tl: the x brick (NI planes from ci0) and the g tile
// (2 MI planes from co0); neighbouring threads take a voxel's planes
template <int MI, int NI>
__device__ void load_tile(const Params& p, const Tile& tl, unsigned char* st,
                          int ci0, int co0) {
  const float* sc = nullptr;
  const float* sh = nullptr;
  if (p.in_scale != nullptr && !p.vec_x) {
    sc = p.in_scale + (size_t)tl.b * p.ci;
    sh = p.in_shift + (size_t)tl.b * p.ci;
  }
  {
    const int plane = threadIdx.x % NI, c0 = ci0 + 8 * plane;
    unsigned char* base = st + plane * XPLANE;
#pragma unroll
    for (int k = 0; k < Stage<MI, NI>::XSLOTS; ++k) {
      const int pos = threadIdx.x / NI + k * (NT / NI);
      if (pos >= BRICK) break;
      const int v = brick_voxel(p, tl, pos);
      if (p.vec_x) {
        const bool ok = v >= 0 && c0 < p.ci;
        cp_async16(smem_u32(base + pos * 16),
                   ok ? p.x + (size_t)v * p.ci + c0 : p.x, ok);
      } else {
        *reinterpret_cast<uint4*>(base + pos * 16) =
            gather8(p.x, v, p.ci, c0, sc, sh, p.slope);
      }
    }
  }
  const int plane = threadIdx.x % (2 * MI), c0 = co0 + 8 * plane;
  unsigned char* base = st + Stage<MI, NI>::X_BYTES + plane * GPLANE;
#pragma unroll
  for (int k = 0; k < Stage<MI, NI>::GSLOTS; ++k) {
    const int q = threadIdx.x / (2 * MI) + k * (NT / (2 * MI));
    if (q >= TILE) break;
    const int v = voxel(p, tl.b, tl.z0 + q / (TH * TW), tl.y0 + (q / TW) % TH,
                        tl.x0 + q % TW);
    if (p.vec_g) {
      const bool ok = v >= 0 && c0 < p.co;
      cp_async16(smem_u32(base + q * 16),
                 ok ? p.g + (size_t)v * p.co + c0 : p.g, ok);
    } else {
      *reinterpret_cast<uint4*>(base + q * 16) =
          gather8(p.g, v, p.co, c0, nullptr, nullptr, 0.f);
    }
  }
}

// the prologue in place on the staged brick of tile tl (the vector
// loader's path): in-volume positions and real channels only, each thread
// over its own slots, whose plane's affine it holds in registers
template <int MI, int NI>
__device__ void prologue_in_place(const Params& p, const Tile& tl,
                                  unsigned char* st, int ci0) {
  const int plane = threadIdx.x % NI, c0 = ci0 + 8 * plane;
  if (c0 >= p.ci) return;
  float sc[8], sh[8];
  const float4* s4 =
      reinterpret_cast<const float4*>(p.in_scale + (size_t)tl.b * p.ci + c0);
  const float4* h4 =
      reinterpret_cast<const float4*>(p.in_shift + (size_t)tl.b * p.ci + c0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 a = __ldg(s4 + j), c = __ldg(h4 + j);
    sc[4 * j] = a.x, sc[4 * j + 1] = a.y, sc[4 * j + 2] = a.z,
    sc[4 * j + 3] = a.w;
    sh[4 * j] = c.x, sh[4 * j + 1] = c.y, sh[4 * j + 2] = c.z,
    sh[4 * j + 3] = c.w;
  }
  unsigned char* base = st + plane * XPLANE;
#pragma unroll
  for (int k = 0; k < Stage<MI, NI>::XSLOTS; ++k) {
    const int pos = threadIdx.x / NI + k * (NT / NI);
    if (pos >= BRICK) break;
    if (brick_voxel(p, tl, pos) < 0) continue;
    uint4* q = reinterpret_cast<uint4*>(base + pos * 16);
    uint4 val = *q;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      float u = fmaf(f.x, sc[2 * j], sh[2 * j]);
      float w = fmaf(f.y, sc[2 * j + 1], sh[2 * j + 1]);
      u = u >= 0.f ? u : p.slope * u;
      w = w >= 0.f ? w : p.slope * w;
      e[j] = __floats2bfloat162_rn(u, w);
    }
    *q = val;
  }
}

// MI: co tile / 16 (A row tiles); NI: ci tile / 8 (B column tiles). Chunk
// c (blockIdx.y) walks tiles c, c + chunks, c + 2 chunks, ...: the blocks
// work through the volume side by side, so a tile's halo is mostly in L2,
// loaded by its neighbours' blocks at about the same time.
template <int MI, int NI>
__global__ void __launch_bounds__(NT, MI * NI <= 2 ? 3 : MI * NI <= 4 ? 2 : 1)
    wgrad_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SB = Stage<MI, NI>::BYTES;
  const int ci0 = (blockIdx.x / p.nco) * 8 * NI;
  const int co0 = (blockIdx.x % p.nco) * 16 * MI;
  const int chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dz = warp / 3, dy = warp % 3;
  const bool pro_in_place = p.in_scale != nullptr && p.vec_x;

  // per-lane parts of the ldmatrix row addresses: lane = 8 mat + r, r the
  // voxel's x. g (A): matrices (plane 2i, rows 0-7), (2i + 1, 0-7),
  // (2i, 8-15), (2i + 1, 8-15) -> a0..a3 of m-tile i. x (B): matrices
  // (plane 2jp, k 0-7), (2jp, k 8-15), (2jp + 1, 0-7), (2jp + 1, 8-15) ->
  // b0, b1 of n-tiles 2jp and 2jp + 1. k 0-7 is the k-step's first y-row,
  // 8-15 its second.
  const int mat = lane >> 3, r = lane & 7;
  const uint32_t g_lane = (mat & 1) * GPLANE + ((mat >> 1) * TW + r) * 16;
  const uint32_t x_lane =
      (NI > 1 ? (mat >> 1) * XPLANE : 0) +
      ((dz * BH + dy + (mat & 1)) * BW + r) * 16;

  float acc[3][MI][NI][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0.f;

  int t = blockIdx.y;
  load_tile<MI, NI>(p, tile_at(p, t), smem, ci0, co0);
  cp_async_commit();
  for (int n = 0; t < p.tiles; ++n, t += chunks) {
    unsigned char* st = smem + (n & 1) * SB;
    if (t + chunks < p.tiles)
      load_tile<MI, NI>(p, tile_at(p, t + chunks), smem + ((n + 1) & 1) * SB,
                        ci0, co0);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const Tile tl = tile_at(p, t);
    if (pro_in_place) {
      prologue_in_place<MI, NI>(p, tl, st, ci0);
      __syncthreads();
    }
    const uint32_t xs = smem_u32(st) + x_lane;
    const uint32_t gs = smem_u32(st) + Stage<MI, NI>::X_BYTES + g_lane;
#pragma unroll 1
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int z = ks / (TH / 2), y = 2 * (ks % (TH / 2));
      if (tl.z0 + z >= p.D || tl.y0 + y >= p.H) continue;
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4_t(a[i], gs + 2 * i * GPLANE + ((z * TH + y) * TW) * 16);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t xb = xs + ((z * BH + y) * BW + dx) * 16;
        uint32_t b[NI][2];
        if constexpr (NI == 1) {
          ldsm_x2_t(b[0], xb);
        } else {
#pragma unroll
          for (int jp = 0; jp < NI / 2; ++jp) {
            uint32_t q[4];
            ldsm_x4_t(q, xb + 2 * jp * XPLANE);
            b[2 * jp][0] = q[0];
            b[2 * jp][1] = q[1];
            b[2 * jp + 1][0] = q[2];
            b[2 * jp + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma16816(acc[dx][i][j], a[i], b[j]);
      }
    }
    __syncthreads();  // every warp is done with this stage: it may refill
  }

  // accumulator e of tile (i, j) is co 16 i + lane / 4 (+ 8 for e >= 2),
  // ci 8 j + 2 (lane % 4) + (e & 1)
  float* o = p.out + (size_t)blockIdx.y * 27 * p.ci * p.co;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int tap = 3 * warp + d;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = co0 + 16 * i + gid + 8 * (e >> 1);
          const int ci = ci0 + 8 * j + 2 * tig + (e & 1);
          if (ci < p.ci && co < p.co)
            o[((size_t)tap * p.ci + ci) * p.co + co] = acc[d][i][j][e];
        }
  }
}

// dW[e] = sum over chunks of part[chunk, e]: SEG runs of consecutive chunks,
// each summed in chunk order by one warp row, then the runs in order
__global__ void __launch_bounds__(32 * SEG)
    wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                     int n, int chunks) {
  __shared__ float run[SEG][32];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int per = (chunks + SEG - 1) / SEG;
  const int c1 = min(chunks, (s + 1) * per);
  float acc = 0.f;
  if (e < n)
    for (int c = s * per; c < c1; ++c) acc += part[(size_t)c * n + e];
  run[s][lane] = acc;
  __syncthreads();
  if (s == 0 && e < n) {
    float t = run[0][lane];
#pragma unroll
    for (int k = 1; k < SEG; ++k) t += run[k][lane];
    dw[e] = t;
  }
}

template <int MI, int NI>
int launch(const Params& p, int ntiles, int chunks, cudaStream_t s) {
  const int bytes = 2 * Stage<MI, NI>::BYTES;
  auto kern = wgrad_mma_kernel<MI, NI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(ntiles, chunks), NT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MI>
int launch_ni(const Params& p, int ci_tile, int ntiles, int chunks,
              cudaStream_t s) {
  if (ci_tile == 8) return launch<MI, 1>(p, ntiles, chunks, s);
  if (ci_tile == 16) return launch<MI, 2>(p, ntiles, chunks, s);
  if (ci_tile == 32) return launch<MI, 4>(p, ntiles, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan comes from the wrapper (kernels/conv_wgrad.py::wgrad_plan):
// ci_tile in {8, 16, 32}, co_tile in {16, 32}, ntz x nty x ntx voxel tiles
// of 4 x 8 x 8 per batch item, chunks chunks (chunk c: tiles c, c + chunks,
// c + 2 chunks, ...).
// With chunks > 1 `part` is a (chunks, 27, ci, co) scratch buffer and the
// second pass writes dw; with one chunk the blocks write dw (part unused).
extern "C" int fcd_conv3d_wgrad(const void* x, const void* g,
                                const float* in_scale, const float* in_shift,
                                float slope, float* part, float* dw, int B,
                                int D, int H, int W, int ci, int co,
                                int ci_tile, int co_tile, int ntz, int nty,
                                int ntx, int chunks, int vec_x,
                                int vec_g, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.slope = slope;
  p.out = chunks > 1 ? part : dw;
  p.D = D;
  p.H = H;
  p.W = W;
  p.ci = ci;
  p.co = co;
  p.ntz = ntz;
  p.nty = nty;
  p.ntx = ntx;
  p.tiles = B * ntz * nty * ntx;
  p.nco = (co + co_tile - 1) / co_tile;
  p.vec_x = vec_x;
  p.vec_g = vec_g;
  const int ntiles = ((ci + ci_tile - 1) / ci_tile) * p.nco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (co_tile == 16)
    err = launch_ni<1>(p, ci_tile, ntiles, chunks, s);
  else if (co_tile == 32)
    err = launch_ni<2>(p, ci_tile, ntiles, chunks, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || chunks == 1) return err;
  const int n = 27 * ci * co;
  wgrad_sum_kernel<<<(n + 31) / 32, 32 * SEG, 0, s>>>(part, dw, n, chunks);
  return static_cast<int>(cudaGetLastError());
}
