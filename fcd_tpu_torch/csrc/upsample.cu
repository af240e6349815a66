// B4: k2 s2 transposed convolution, the decoders' upsample (Hopper, sm_90a).
//
// Replaces fcd_tpu/kernels/upsample.py::upsample_s2d_pad (and the gated-off
// upsample_s2d_pallas). It computes the op's function on dense NDHWC
// tensors:
//
//   out[b, 2z+a, 2y+c, 2x+e, o] = bias[o] + sum_i x[b, z, y, x, i] * kernel[1-a, 1-c, 1-e, i, o]
//
// (lax.conv_transpose correlates the stride-dilated input with the kernel
// as it is, so output parity a reads tap 1-a). Each coarse voxel feeds
// exactly one fine voxel per parity, so the op is one GEMM: M = coarse
// voxels (batch included), K = ci, N = 8 * co, column n = q * co + o with
// q = 4a + 2c + e, whose epilogue scatters N onto the 2x2x2 fine block.
// The kernel reads the flax (2, 2, 2, ci, co) kernel as it is, viewed as
// (8, ci, co): column n takes row 7 - q, which is the flip (1-a, 1-c, 1-e)
// folded into the index. f32 weights are rounded to bf16 on load (round to
// nearest even, the value .to(torch.bfloat16) gives), so a call is one
// launch: no packed matrix, flip or cast is built per call.
//
// What bounds it (H100: 989 TFLOP/s bf16, 3.35 TB/s): 2 * ci operations
// per output element against 2 bytes written, ~ci operations per byte
// (32..256 on the decoders), under the card's ~295: the bytes it writes.
// At dec1 (1 x 64^3, 32 -> 16) it writes 67 MB of the 84 MB it moves.
// So the design is about the stores; the tensor cores take the products
// off the critical path:
//   * Products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     accumulators) fed by ldmatrix, as K1 (conv3d_wgrad.cu). A warpgroup
//     wgmma wants 64-row tiles and a deep ring to pay off; here the tiles
//     are 16-64 voxels by 16-64 columns, K is 32-256, and the small
//     decoders need tiles of 16 voxels to fill the card, which warp-level
//     mma.sync serves with one code path.
//   * A block owns one column tile and walks voxel tiles: its weights
//     (all of ci x BN, rounded to bf16 on load) are staged once, and each
//     tile's x (BM voxels x ci) arrives by 16-byte cp.async in a ring of
//     STAGES, three tiles ahead, so the loads overlap the products and the
//     stores of the tiles before. Rows are padded so that ldmatrix reads
//     them without bank conflicts. Ragged ci (not a multiple of 8) and
//     ragged co (columns not a multiple of 8) load element by element,
//     zero-filled.
//   * Epilogue: the accumulators, plus the bias in f32, rounded once to
//     bf16, are staged in shared memory as the tile's output rows; then the
//     threads copy them out in 16-byte stores, neighbouring threads on
//     neighbouring addresses. For one coarse voxel and one parity pair
//     (a, c) the columns of e = 0, 1 (2 * co values) are one contiguous run
//     of the output (fine voxels 2x and 2x + 1 sit side by side), and the
//     next voxel along x continues it, so every store fills whole sectors.
//     co not a multiple of 4 stores element by element.
//   * Tiles and walks (kernels/upsample.py::upsample_plan, pure Python):
//     the largest of 64 x 64, 32 x 64, 32 x 32 and 16 x 16 whose tiles
//     give at least one block per SM, so the 4^3 and 8^3 decoders (64 and
//     512 coarse voxels at batch 1) still spread over the card; the walks
//     keep about six blocks on each SM. kernels/upsample_sweep.py times
//     the alternatives on the card (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int STAGES = 4;   // the ring of x tiles

struct Params {
  const bf16* x;      // (M, ci), M = B * D * H * W coarse voxels
  const void* w;      // the flax kernel viewed (8, ci, co), bf16 or f32
  const void* bias;   // (co,) bf16 or f32, or null
  bf16* out;          // (B, 2D, 2H, 2W, co)
  int M, D, H, W, ci, co;
  int kt;             // ci rounded up to 16: the staged depth
  int m_tiles;        // BM-voxel tiles, walked by gridDim.x blocks
  int w_f32, bias_f32;
  int vec_x, vec_w, vec_out;  // 16-byte accesses allowed
};

// eight bf16 (their bits) as one 16-byte vector
union Vec8 {
  uint4 u;
  unsigned short h[8];
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte cp.async; src_size 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the N most recent groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// weight element (k, n) as bf16 bits: row 7 - q of the (8, ci, co) kernel
__device__ __forceinline__ unsigned short weight_at(const Params& p, int k,
                                                    int n) {
  const int q = n / p.co, o = n - q * p.co;
  const size_t i = ((size_t)(7 - q) * p.ci + k) * p.co + o;
  return __bfloat16_as_ushort(
      p.w_f32 ? __float2bfloat16_rn(static_cast<const float*>(p.w)[i])
              : static_cast<const bf16*>(p.w)[i]);
}

// x rows m0 .. m0 + BM of one tile into As (pitch ap), zero outside
template <int BM, int NT>
__device__ __forceinline__ void load_x(const Params& p, bf16* As, int ap,
                                       int m0) {
  const int per_row = p.kt / 8;
  for (int v = threadIdx.x; v < BM * per_row; v += NT) {
    const int r = v / per_row, k = (v - r * per_row) * 8;
    const int m = m0 + r;
    const bf16* src = p.x + (size_t)(m < p.M ? m : 0) * p.ci + k;
    bf16* dst = As + r * ap + k;
    if (p.vec_x) {
      cp_async16(smem_u32(dst), src, m < p.M && k < p.ci);
    } else {
      Vec8 e;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e.h[j] = m < p.M && k + j < p.ci ? __bfloat16_as_ushort(src[j]) : 0;
      *reinterpret_cast<uint4*>(dst) = e.u;
    }
  }
}

// WM x WN warps, each a 16 x (8 * NI) tile of the BM x BN block tile. A
// block owns one column tile and walks the voxel tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...: its weights are staged once, and the x of
// the next STAGES - 1 tiles loads (cp.async, a ring of STAGES) while this
// one multiplies and stores.
template <int WM, int WN, int NI>
__global__ void __launch_bounds__(32 * WM * WN)
    upsample_kernel(const Params p) {
  constexpr int NT = 32 * WM * WN;
  constexpr int BM = 16 * WM;
  constexpr int BN = 8 * NI * WN;
  constexpr int NP = BN + 8;   // pitch of a weight row and an output row
  const int ap = p.kt + 8;     // pitch of an x row: ldmatrix rows in
                               // distinct banks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ long long rowbase[BM];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);   // kt x NP
  bf16* As = Ws + p.kt * NP;                      // STAGES x BM x ap
  bf16* Cs = As + STAGES * BM * ap;               // BM x NP, the output

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const int N = 8 * p.co;
  const int step = gridDim.x;

  // the ring's first STAGES - 1 tiles, a commit group each
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    const int mt = blockIdx.x + j * step;
    if (mt < p.m_tiles) load_x<BM, NT>(p, As + j * BM * ap, ap, mt * BM);
    cp_async_commit();
  }

  // the weights: kt rows x BN columns, BN / 8 vectors a row, f32 rounded
  // to bf16 here
  for (int v = tid; v < p.kt * (BN / 8); v += NT) {
    const int k = v / (BN / 8), nv = (v % (BN / 8)) * 8;
    const int n = n0 + nv;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k < p.ci && n < N) {
      if (p.vec_w) {
        // co % 8 == 0: the 8 columns are 8 consecutive o of one q
        const int q = n / p.co, o = n - q * p.co;
        const size_t i = ((size_t)(7 - q) * p.ci + k) * p.co + o;
        if (p.w_f32) {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(p.w) + i);
          const float4 lo = src[0], hi = src[1];
          val = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                           pack2(hi.x, hi.y), pack2(hi.z, hi.w));
        } else {
          val = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(p.w) + i);
        }
      } else {
        Vec8 e;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e.h[j] = n + j < N ? weight_at(p, k, n + j) : 0;
        val = e.u;
      }
    }
    *reinterpret_cast<uint4*>(Ws + k * NP + nv) = val;
  }

  // each column's bias and its place in a fine run: parity pair (a, c) =
  // n / (2 co) picks the fine row, e * co + o the place in its run
  const long long plane_a = 4LL * p.H * p.W * p.co;   // fine z + 1
  const long long row_c = 2LL * p.W * p.co;           // fine y + 1
  const int run = 2 * p.co;
  const int rb = (warp % WM) * 16;
  const int cb = (warp / WM) * 8 * NI;
  float bias[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + cb + j * 8 + 2 * (lane & 3);
    bias[j][0] = bias[j][1] = 0.f;
    if (p.bias != nullptr && n < N) {
      // n is even and N = 8 co: n + 1 < N, perhaps in the next q
      const int o0 = n % p.co, o1 = o0 + 1 == p.co ? 0 : o0 + 1;
      if (p.bias_f32) {
        const float* bs = static_cast<const float*>(p.bias);
        bias[j][0] = bs[o0];
        bias[j][1] = bs[o1];
      } else {
        const bf16* bs = static_cast<const bf16*>(p.bias);
        bias[j][0] = __bfloat162float(bs[o0]);
        bias[j][1] = __bfloat162float(bs[o1]);
      }
    }
  }

  int stage = 0;
  for (int mt = blockIdx.x; mt < p.m_tiles; mt += step) {
    const int m0 = mt * BM;
    // the tile STAGES - 1 ahead takes the ring's slot of the last tile
    const int ahead = mt + (STAGES - 1) * step;
    const int slot = stage == 0 ? STAGES - 1 : stage - 1;
    if (ahead < p.m_tiles)
      load_x<BM, NT>(p, As + slot * BM * ap, ap, ahead * BM);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    // this tile's x has landed; the last tile's stores are done with Cs
    // and its products with its slot
    __syncthreads();

    float acc[NI][4];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    const bf16* xs = As + stage * BM * ap;
    for (int k0 = 0; k0 < p.kt; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(xs + (rb + (lane & 15)) * ap + k0 +
                          (lane >> 4) * 8));
      const bf16* wrow = Ws + (k0 + (lane & 15)) * NP + cb;
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        if (j + 1 < NI) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(wrow + j * 8 + (lane >> 4) * 8));
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        } else {
          uint32_t b[2];
          ldsm_x2_t(b, smem_u32(wrow + j * 8));
          mma16816(acc[j], a, b[0], b[1]);
        }
      }
    }

    // each row's fine voxel (2z, 2y, 2x), as an element offset of out
    for (int r = tid; r < BM; r += NT) {
      int t = m0 + r < p.M ? m0 + r : 0;
      const int xx = t % p.W;
      t /= p.W;
      const int y = t % p.H;
      t /= p.H;
      const int z = t % p.D;
      const int b = t / p.D;
      rowbase[r] = ((((long long)b * 2 * p.D + 2 * z) * 2 * p.H + 2 * y) *
                        2 * p.W + 2 * xx) * p.co;
    }
    // the tile's output rows: bias in f32, one bf16 rounding
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = cb + j * 8 + 2 * (lane & 3);
      const int r = rb + (lane >> 2);
      *reinterpret_cast<uint32_t*>(Cs + r * NP + c) =
          pack2(acc[j][0] + bias[j][0], acc[j][1] + bias[j][1]);
      *reinterpret_cast<uint32_t*>(Cs + (r + 8) * NP + c) =
          pack2(acc[j][2] + bias[j][0], acc[j][3] + bias[j][1]);
    }
    __syncthreads();

    if (p.vec_out) {
      for (int v = tid; v < BM * (BN / 8); v += NT) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const int n = n0 + c;
        if (m0 + r >= p.M || n >= N) continue;
        const int pair = n / run;
        const long long off = rowbase[r] + (pair >> 1) * plane_a +
                              (pair & 1) * row_c + (n - pair * run);
        *reinterpret_cast<uint4*>(p.out + off) =
            *reinterpret_cast<const uint4*>(Cs + r * NP + c);
      }
    } else {
      for (int v = tid; v < BM * BN; v += NT) {
        const int r = v / BN, c = v % BN;
        const int n = n0 + c;
        if (m0 + r >= p.M || n >= N) continue;
        const int pair = n / run;
        p.out[rowbase[r] + (pair >> 1) * plane_a + (pair & 1) * row_c +
              (n - pair * run)] = Cs[r * NP + c];
      }
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
}

template <int WM, int WN, int NI>
int launch(const Params& p, int m_blocks, cudaStream_t s) {
  constexpr int BM = 16 * WM, BN = 8 * NI * WN, NP = BN + 8;
  // the weights, the ring of x tiles, the output tile
  // (kernels/upsample.py::smem_bytes)
  const int bytes = 2 * (p.kt * NP + STAGES * BM * (p.kt + 8) + BM * NP);
  auto kern = upsample_kernel<WM, WN, NI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(m_blocks, (8 * p.co + BN - 1) / BN), 32 * WM * WN, bytes, s>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// tile: index into kernels/upsample.py::TILES, (WM, WN, NI) per entry;
// m_tiles voxel tiles walked by m_blocks blocks per column tile
extern "C" int fcd_upsample(const void* x, const void* w, const void* bias,
                            void* out, int B, int D, int H, int W, int ci,
                            int co, int w_f32, int bias_f32, int tile,
                            int m_tiles, int m_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = w;
  p.bias = bias;
  p.out = static_cast<bf16*>(out);
  p.M = B * D * H * W;
  p.D = D;
  p.H = H;
  p.W = W;
  p.ci = ci;
  p.co = co;
  p.kt = (ci + 15) / 16 * 16;
  p.m_tiles = m_tiles;
  p.w_f32 = w_f32;
  p.bias_f32 = bias_f32;
  p.vec_x = ci % 8 == 0 && aligned16(x);
  p.vec_w = co % 8 == 0 && aligned16(w);
  p.vec_out = co % 4 == 0 && aligned16(out);
  switch (tile) {
    case 0: return launch<4, 1, 8>(p, m_blocks, s);
    case 1: return launch<2, 2, 4>(p, m_blocks, s);
    case 2: return launch<2, 2, 2>(p, m_blocks, s);
    case 3: return launch<1, 2, 1>(p, m_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
