// B1: 3x3x3 "same" convolution of the residual blocks (Hopper, sm_90a).
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
//     never materialised: part 1's k-steps follow part 0's into the same
//     accumulators);
//   * a prologue on part 0: pro(v) = bf16(leaky(v * scale[b, c] + shift[b, c]))
//     (norm1's affine and the activation fused into conv2's loads); taps
//     outside the volume read 0 AFTER the prologue, as zero padding of the
//     activated tensor;
//   * a 1x1 shortcut output r = sum_p x_p[b, v, :] @ wr_p from the centre
//     tap's operand, into a second accumulator;
//   * per-(b, o) sum and sum of squares of the f32 results of y and r (the
//     next instance norm's statistics): each block writes its partial sums
//     once, at (spatial tile, b, o) of a (tiles, B, cout) buffer, and the
//     wrapper adds them over the tiles in a fixed order, so the statistics,
//     and the forward after them, are the same bits from run to run.
//
// Inputs bf16, f32 accumulation, bf16 outputs, f32 statistics.
//
// The partial instance (fcd_conv3d_partial, template flag PARTIAL) is the
// row-parallel conv of tensor parallelism (fcd_tpu/parallel/tp.py): one
// part, this rank's slice of the input channels, the prologue on that
// slice. Its result is one addend of the conv, so the epilogue stores the
// f32 accumulators as they are, takes no statistics and writes no
// shortcut; the ranks' partials are summed in f32 and csrc/conv_finish.cu
// then rounds the sum and takes the statistics, at the points where this
// kernel does on one device. Same products, same loads: only the store
// differs (8-byte f32 pairs straight from the registers).
//
// Design: an implicit GEMM on the tensor cores. M = output voxels, N = cout,
// K = 27 taps x input channels. A block is two warpgroups and owns a
// TD x 8 x 8 output tile (TD = 2 or 4) and a BN-wide slice of cout
// (BN = 16, 32 or 64); the wrapper (kernels/block_conv.py::conv_tiling)
// chooses TD, BN and the grid. For each k-step of 16 input channels it
// stages the tile's halo brick, (TD+2) x 10 x 10 x 16, once in shared
// memory, with the 27 taps' (16 x BN) weight slices (pre-packed K-major by
// the wrapper), and runs all 27 taps from it: the A operand of a tap is a
// shared-memory descriptor into the brick, shifted by the tap's offset.
// The brick is laid out as two 8-channel planes of 16-byte voxels, x
// fastest, so one m64 wgmma tile (8 rows of y x 8 voxels of x) is eight
// 8 x 16-byte core matrices at a constant 160-byte pitch, and the two
// planes are the k16 step's two core matrices. Every product is a
// wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in registers).
//
// What bounds each regime, and what the design does about it:
//   * 128^3 and 64^3 grids, C and cout of 16-32 (79% of a patch's
//     operations): close to the line between the two bounds (enc1.conv2's
//     134 MB of input and output outweigh its 29 GFLOP; dec2.conv1's
//     operations outweigh its bytes). The input crosses device memory once
//     per tile plus its halo (2.3x at TD = 4, against 27x for a per-tap
//     gather), copied by cp.async in 16-byte vectors (zero-filled outside
//     the volume) into a ring of two k-step stages, so the next k-step
//     loads while the tensor cores multiply the current one; where C = 16
//     there is one k-step, and four blocks per SM overlap each other's
//     loads and products instead. The prologue
//     runs once per staged value, in shared memory, and leaves the
//     out-of-volume positions at 0.
//   * 4^3 to 16^3 grids with 128-512 channels: the weights' bytes (14.2 MB
//     at enc6.conv2) and too few tiles to fill 132 SMs. The grid spreads
//     over cout slices (BN falls to 16 until there are 132 blocks or no
//     narrower slice), so that many SMs stream weights at once.
//   * C not a multiple of 8 (the image's C = 2): a 16-byte cp.async would
//     straddle voxels, so another loader (a template branch) reads the
//     real channels one by one and writes whole 16-byte vectors, zero-
//     padding the channels to 16 in shared memory; the tensor cores then
//     multiply 8x the useful K at that one conv. (Packing taps into K,
//     27 x 2 -> 64, would cut that; at 128^3 the conv measured about as
//     long as the C = 16 convs, so it stays as it is.)
//   * cout not a multiple of BN, grids not a multiple of the tile: the
//     weights are zero-padded by the wrapper, rows outside the volume are
//     masked out of the statistics and the stores, and a cout that is not a
//     multiple of 8 takes 2-byte stores.
// The epilogue reduces each tile's statistics from the accumulator
// registers (warp shuffles, then a fixed-order sum over the 8 warps),
// rounds y and r to bf16 and stages them through shared memory for
// coalesced 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 8;            // a z-slice of the tile: one m64
constexpr int BH = TH + 2, BW = TW + 2;  // its halo brick
constexpr int KC = 16;                   // input channels per k-step
constexpr int NT = 256;                  // two warpgroups
constexpr int TAPS = 27;

typedef __nv_bfloat16 bf16;

struct Part {
  const bf16* x;   // (B, D, H, W, c)
  const bf16* w;   // packed (cout/BN, nchunk, 27, 2, BN, 8)
  const bf16* wr;  // packed (cout/BN, nchunk, 1, 2, BN, 8) shortcut, or null
  int c;
  int nchunk;      // k-steps: ceil(c / 16)
};

struct Params {
  Part part[2];
  int nparts;
  const float* in_scale;  // (B, c of part 0) prologue, or null
  const float* in_shift;
  float slope;
  bf16* y;                // (B, D, H, W, cout)
  bf16* r;                // (B, D, H, W, cout) shortcut output, or null
  float* yf;              // (B, D, H, W, cout) f32 partial (PARTIAL only)
  float* ysum;            // (tiles, B, cout) partial statistics, or null
  float* ysq;
  float* rsum;
  float* rsq;
  int D, H, W, cout;
  int nty, ntx;           // tiles along y and x
  int stage_bytes;        // one k-step stage of the shared-memory ring
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes; lbo = byte distance of the two core matrices along K,
// sbo = byte distance of consecutive 8-row groups along M (or N)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d[64 x N] += A[64 x 16] . B[16 x N], A and B by descriptor
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}"
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,"
        "%24,%25,%26,%27,%28,%29,%30,%31}"
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// brick position pos = (bz * BH + by) * BW + bx of the tile at (z0, y0, x0)
// -> its voxel, and whether it lies inside the volume
__device__ __forceinline__ bool brick_voxel(const Params& p, int pos, int z0,
                                            int y0, int x0, size_t* vox) {
  const int bx = pos % BW, by = (pos / BW) % BH, bz = pos / (BW * BH);
  const int z = z0 - 1 + bz, y = y0 - 1 + by, x = x0 - 1 + bx;
  *vox = ((size_t)z * p.H + y) * p.W + x;
  return z >= 0 && z < p.D && y >= 0 && y < p.H && x >= 0 && x < p.W;
}

__device__ __forceinline__ float prologue(float v, float sc, float sh,
                                          float slope) {
  v = fmaf(v, sc, sh);
  v = v >= 0.f ? v : slope * v;
  return __bfloat162float(__float2bfloat16(v));
}

// at BN = 16 four blocks share an SM (at most 64 registers a thread): the
// single-k-step convs of the 128^3 level hide their loads behind the other
// blocks' products
template <int BN, int MT, bool VEC, bool PARTIAL>
__global__ void __launch_bounds__(NT, BN == 16 ? 4 : 1)
    conv3d_kernel(const Params p) {
  constexpr int TD = 2 * MT;
  constexpr int BRICK = (TD + 2) * BH * BW;          // positions
  constexpr int BRICK_BYTES = 2 * BRICK * 16;        // two 8-channel planes
  constexpr int W_BYTES = TAPS * 2 * BN * 16;        // 27 taps of 16 x BN
  constexpr int NACC = BN / 2;                       // f32 per thread per m64
  constexpr int OP = BN + 8;                         // staged output pitch
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][8][BN];

  const int tile = blockIdx.x;
  const int tx = tile % p.ntx, ty = (tile / p.ntx) % p.nty,
            tz = tile / (p.ntx * p.nty);
  const int z0 = tz * TD, y0 = ty * TH, x0 = tx * TW;
  const int nt = blockIdx.y, n0 = nt * BN, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool want_r = p.r != nullptr;
  const bool pro = p.in_scale != nullptr;
  const size_t nvox = (size_t)p.D * p.H * p.W;
  const int nchunks = p.part[0].nchunk + (p.nparts > 1 ? p.part[1].nchunk : 0);

  // stage k-step k (part, 16-channel chunk) into ring slot s
  auto load = [&](int k, int s) {
    unsigned char* st = smem + s * p.stage_bytes;
    const int pi = k < p.part[0].nchunk ? 0 : 1;
    const Part pt = pi == 0 ? p.part[0] : p.part[1];
    const int ck = pi == 0 ? k : k - p.part[0].nchunk;
    const int c0 = ck * KC, C = pt.c;
    const bf16* wsrc = pt.w + ((size_t)nt * pt.nchunk + ck) * (W_BYTES / 2);
    for (int i = tid; i < W_BYTES / 16; i += NT)
      cp_async16(smem_u32(st + BRICK_BYTES + 16 * i), wsrc + 8 * i, true);
    if (want_r) {
      const bf16* rsrc = pt.wr + ((size_t)nt * pt.nchunk + ck) * (BN * 16);
      for (int i = tid; i < 2 * BN; i += NT)
        cp_async16(smem_u32(st + BRICK_BYTES + W_BYTES + 16 * i), rsrc + 8 * i,
                   true);
    }
    const bf16* xb = pt.x + (size_t)b * nvox * C;
    if (VEC) {
      // 16-byte vectors of 8 channels; neighbouring threads take the two
      // planes of a voxel, then the next voxel
      for (int i = tid; i < 2 * BRICK; i += NT) {
        const int cg = i & 1, pos = i >> 1;
        size_t vox;
        const bool ok = brick_voxel(p, pos, z0, y0, x0, &vox) &&
                        c0 + 8 * cg < C;
        const bf16* src = ok ? xb + vox * C + c0 + 8 * cg : xb;
        cp_async16(smem_u32(st + (cg * BRICK + pos) * 16), src, ok);
      }
    } else {
      // any C: each thread builds whole 16-byte vectors from the chunk's
      // real channels (zeros beyond C and outside the volume), with the
      // prologue applied here
      const bool pro_here = pro && pi == 0;
      for (int i = tid; i < 2 * BRICK; i += NT) {
        const int cg = i & 1, pos = i >> 1, cb = c0 + 8 * cg;
        size_t vox;
        uint4 v = make_uint4(0, 0, 0, 0);
        bf16* e = reinterpret_cast<bf16*>(&v);
        if (brick_voxel(p, pos, z0, y0, x0, &vox)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = cb + j;
            if (c >= C) break;
            float f = __bfloat162float(xb[vox * C + c]);
            if (pro_here)
              f = prologue(f, p.in_scale[(size_t)b * C + c],
                           p.in_shift[(size_t)b * C + c], p.slope);
            e[j] = __float2bfloat16(f);
          }
        }
        *reinterpret_cast<uint4*>(st + (cg * BRICK + pos) * 16) = v;
      }
    }
  };

  float acc[MT][NACC], racc[MT][NACC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      acc[m][j] = 0.f;
      racc[m][j] = 0.f;
    }

  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    const int s = k & 1;
    unsigned char* st = smem + s * p.stage_bytes;
    cp_async_wait_all();
    __syncthreads();
    if (VEC && pro && k < p.part[0].nchunk) {
      // the prologue in place, on in-volume positions and real channels
      const int C = p.part[0].c, c0 = k * KC;
      for (int i = tid; i < 2 * BRICK; i += NT) {
        const int cg = i & 1, pos = i >> 1;
        size_t vox;
        if (!brick_voxel(p, pos, z0, y0, x0, &vox) || c0 + 8 * cg >= C)
          continue;
        uint4* q = reinterpret_cast<uint4*>(st + (cg * BRICK + pos) * 16);
        uint4 v = *q;
        bf16* e = reinterpret_cast<bf16*>(&v);
        const size_t at = (size_t)b * C + c0 + 8 * cg;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(prologue(__bfloat162float(e[j]),
                                           p.in_scale[at + j],
                                           p.in_shift[at + j], p.slope));
        *q = v;
      }
    }
    fence_async_smem();
    __syncthreads();

    const uint32_t base = smem_u32(st);
    const uint32_t wbase = base + BRICK_BYTES;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      const uint64_t bdesc = smem_desc(wbase + tap * BN * 32, BN * 16, 128);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int zb = wg * MT + m + dz;
        const uint64_t adesc = smem_desc(
            base + ((zb * BH + dy) * BW + dx) * 16, BRICK * 16, BW * 16);
        Mma<BN>::run(acc[m], adesc, bdesc);
        if (tap == 13 && want_r)
          Mma<BN>::run(racc[m], adesc,
                       smem_desc(wbase + W_BYTES, BN * 16, 128));
      }
    }
    wgmma_commit();
    if (k + 1 < nchunks) load(k + 1, s ^ 1);
    cp_async_commit();
    wgmma_wait_all();
  }
  __syncthreads();  // every warpgroup's products are done: the ring is free

  // accumulator element (m, 4 j + 2 h + e) is row 16 warp + 8 h + lane / 4
  // of m64 tile m, column 8 j + 2 (lane % 4) + e; row = 8 y + x in the tile
  const int xl = lane >> 2;
  auto row_ok = [&](int m, int h) {
    return z0 + wg * MT + m < p.D && y0 + 2 * warp + h < p.H && x0 + xl < p.W;
  };

  auto stats = [&](float (&a)[MT][NACC], float* sum, float* sq) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_ok(m, h)) {
              const float v = a[m][4 * j + 2 * h + e];
              s1 += v;
              s2 += v * v;
            }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane < 4) {
          red[0][wg * 4 + warp][8 * j + 2 * lane + e] = s1;
          red[1][wg * 4 + warp][8 * j + 2 * lane + e] = s2;
        }
      }
    __syncthreads();
    for (int n = tid; n < BN; n += NT) {
      if (n0 + n >= p.cout) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s1 += red[0][w][n];
        s2 += red[1][w][n];
      }
      const size_t at = ((size_t)tile * gridDim.z + b) * p.cout + n0 + n;
      sum[at] = s1;
      sq[at] = s2;
    }
    __syncthreads();
  };

  auto store = [&](float (&a)[MT][NACC], bf16* out) {
    bf16* o = reinterpret_cast<bf16*>(smem);  // (TD * 64, OP)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * MT + m) * 64 + 16 * warp + 8 * h + xl;
          *reinterpret_cast<__nv_bfloat162*>(
              o + row * OP + 8 * j + 2 * (lane & 3)) =
              __floats2bfloat162_rn(a[m][4 * j + 2 * h],
                                    a[m][4 * j + 2 * h + 1]);
        }
    __syncthreads();
    bf16* ob = out + (size_t)b * nvox * p.cout;
    if (p.cout % 8 == 0) {
      constexpr int VPR = BN / 8;  // 16-byte vectors per row
      for (int i = tid; i < TD * 64 * VPR; i += NT) {
        const int row = i / VPR, q = i % VPR, n = n0 + 8 * q;
        const int z = z0 + row / 64, y = y0 + (row / 8) % 8, x = x0 + row % 8;
        if (n >= p.cout || z >= p.D || y >= p.H || x >= p.W) continue;
        const size_t v = ((size_t)z * p.H + y) * p.W + x;
        *reinterpret_cast<uint4*>(ob + v * p.cout + n) =
            *reinterpret_cast<const uint4*>(o + row * OP + 8 * q);
      }
    } else {
      for (int i = tid; i < TD * 64 * BN; i += NT) {
        const int row = i / BN, c = i % BN, n = n0 + c;
        const int z = z0 + row / 64, y = y0 + (row / 8) % 8, x = x0 + row % 8;
        if (n >= p.cout || z >= p.D || y >= p.H || x >= p.W) continue;
        const size_t v = ((size_t)z * p.H + y) * p.W + x;
        ob[v * p.cout + n] = o[row * OP + c];
      }
    }
    __syncthreads();
  };

  if constexpr (PARTIAL) {
    // the f32 accumulators, two neighbouring columns a store
    float* ob = p.yf + (size_t)b * nvox * p.cout;
    const bool pairs = p.cout % 2 == 0;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 8 * j + 2 * (lane & 3);
          if (!row_ok(m, h) || n >= p.cout) continue;
          const size_t v =
              ((size_t)(z0 + wg * MT + m) * p.H + y0 + 2 * warp + h) * p.W +
              x0 + xl;
          float* o = ob + v * p.cout + n;
          const float a0 = acc[m][4 * j + 2 * h], a1 = acc[m][4 * j + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(a0, a1);
          } else {
            o[0] = a0;
            if (n + 1 < p.cout) o[1] = a1;
          }
        }
    return;
  }
  if (p.ysum != nullptr) stats(acc, p.ysum, p.ysq);
  store(acc, p.y);
  if (want_r) {
    if (p.rsum != nullptr) stats(racc, p.rsum, p.rsq);
    store(racc, p.r);
  }
}

template <int BN, int MT, bool VEC, bool PARTIAL>
int launch(Params p, int tiles, int ntiles, int B, cudaStream_t s) {
  constexpr int BRICK_BYTES = 2 * (2 * MT + 2) * BH * BW * 16;
  p.stage_bytes = BRICK_BYTES + TAPS * 2 * BN * 16 +
                  (p.r != nullptr ? 2 * BN * 16 : 0);
  const int nchunks =
      p.part[0].nchunk + (p.nparts > 1 ? p.part[1].nchunk : 0);
  // one ring slot where there is one k-step: more blocks fit on an SM
  const int bytes = (nchunks > 1 ? 2 : 1) * p.stage_bytes;
  auto kern = conv3d_kernel<BN, MT, VEC, PARTIAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(tiles, ntiles, B), NT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int MT, bool PARTIAL>
int launch_c(const Params& p, int tiles, int ntiles, int B, cudaStream_t s) {
  const bool vec = p.part[0].c % 8 == 0 &&
                   (p.nparts < 2 || p.part[1].c % 8 == 0);
  return vec ? launch<BN, MT, true, PARTIAL>(p, tiles, ntiles, B, s)
             : launch<BN, MT, false, PARTIAL>(p, tiles, ntiles, B, s);
}

template <bool PARTIAL>
int dispatch(Params& p, int td, int bn, int ntz, int nty, int ntx, int B,
             cudaStream_t s) {
  p.nty = nty;
  p.ntx = ntx;
  const int tiles = ntz * nty * ntx;
  const int ntiles = (p.cout + bn - 1) / bn;
  if (td == 4 && bn == 16) return launch_c<16, 2, PARTIAL>(p, tiles, ntiles, B, s);
  if (td == 4 && bn == 32) return launch_c<32, 2, PARTIAL>(p, tiles, ntiles, B, s);
  if (td == 4 && bn == 64) return launch_c<64, 2, PARTIAL>(p, tiles, ntiles, B, s);
  if (td == 2 && bn == 16) return launch_c<16, 1, PARTIAL>(p, tiles, ntiles, B, s);
  if (td == 2 && bn == 32) return launch_c<32, 1, PARTIAL>(p, tiles, ntiles, B, s);
  if (td == 2 && bn == 64) return launch_c<64, 1, PARTIAL>(p, tiles, ntiles, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Tiling from the wrapper: td in {2, 4} output z-slices per block, bn in
// {16, 32, 64} output channels per block, a grid of ntz x nty x ntx spatial
// tiles x ceil(cout / bn) slices x B. The weights come packed by
// block_conv.py::pack_weights for that bn.
extern "C" int fcd_conv3d(const void* x0, const void* w0, const void* wr0,
                          int c0, const void* x1, const void* w1,
                          const void* wr1, int c1, int nparts,
                          const float* in_scale, const float* in_shift,
                          float slope, void* y, void* r, float* ysum,
                          float* ysq, float* rsum, float* rsq, int B, int D,
                          int H, int W, int cout, int td, int bn, int ntz,
                          int nty, int ntx, void* stream) {
  Params p;
  p.part[0] = {static_cast<const bf16*>(x0), static_cast<const bf16*>(w0),
               static_cast<const bf16*>(wr0), c0, (c0 + KC - 1) / KC};
  p.part[1] = {static_cast<const bf16*>(x1), static_cast<const bf16*>(w1),
               static_cast<const bf16*>(wr1), c1, (c1 + KC - 1) / KC};
  p.nparts = nparts;
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.slope = slope;
  p.y = static_cast<bf16*>(y);
  p.r = static_cast<bf16*>(r);
  p.ysum = ysum;
  p.ysq = ysq;
  p.rsum = rsum;
  p.rsq = rsq;
  p.yf = nullptr;
  p.D = D;
  p.H = H;
  p.W = W;
  p.cout = cout;
  return dispatch<false>(p, td, bn, ntz, nty, ntx, B,
                         static_cast<cudaStream_t>(stream));
}

// The partial instance: one part (x0, its packed weights, c0 channels),
// the optional prologue on it, and yf, the f32 (B, D, H, W, cout) result;
// the tiling as fcd_conv3d's.
extern "C" int fcd_conv3d_partial(const void* x0, const void* w0, int c0,
                                  const float* in_scale,
                                  const float* in_shift, float slope,
                                  float* yf, int B, int D, int H, int W,
                                  int cout, int td, int bn, int ntz, int nty,
                                  int ntx, void* stream) {
  Params p = {};
  p.part[0] = {static_cast<const bf16*>(x0), static_cast<const bf16*>(w0),
               nullptr, c0, (c0 + KC - 1) / KC};
  p.nparts = 1;
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.slope = slope;
  p.yf = yf;
  p.D = D;
  p.H = H;
  p.W = W;
  p.cout = cout;
  return dispatch<true>(p, td, bn, ntz, nty, ntx, B,
                        static_cast<cudaStream_t>(stream));
}
