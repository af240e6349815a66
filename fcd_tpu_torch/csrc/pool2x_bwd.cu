// B9: the 2x2x2 max pool's backward with an even split among ties (Hopper,
// sm_90a).
//
// Replaces fcd_tpu/kernels/pool.py::pool_bwd_pallas (:53, pallas_call :74).
// Per (b, pooled voxel, c), with x bf16 (B, D, H, W, C) and g, the pooled
// output's cotangent, bf16 (B, D/2, H/2, W/2, C):
//
//   m     = max of the block's eight children of x          (recomputed)
//   ties  = the children equal to m
//   dx    = bf16(child == m ? g / ties : 0)                 the quotient f32
//
// The even split is the s2d pool's custom VJP (fcd_tpu/ops/s2d_ops.py:
// 237-252); torch's max-pool backward sends the gradient to one index
// (ROADMAP C1). dx is the plain version's bits (kernels/pool2x.py::
// max_pool2x_bwd_plain): the children are compared as the f32 values of
// their bf16 bits, as the plain version compares them; a block holding a
// NaN has the maximum NaN and so no child equal to it (dx 0, as torch's
// amax and == give); the share is an IEEE division (__fdiv_rn) and every
// rounding to bf16 is cvt.rn.
//
// What bounds it: bytes. Per element it reads x (2 bytes) and writes dx
// (2), and per pooled element reads g once (2/8 of a byte an element),
// against ~4 operations; at 3.35 TB/s the card moves ~790 G elements a
// second. So the design keeps the bytes at that minimum and many of them
// in flight:
//
// - A thread owns V channels of one pooled voxel: it issues the eight
//   children's loads and g's before it uses any of them, takes the
//   maximum, the tie count and the share in registers, and stores the
//   eight children of dx with the width it read. V = 4 (8-byte accesses)
//   holds 8 x 2 + 2 words of loads in 64 registers, four blocks of 256 an
//   SM. V = 8 (16-byte accesses, 36 words) spilled at 64 and at 80
//   registers and lost to V = 4 at every block count on an H100 (enc1
//   0.1974 against 0.1883 ms, PERF.md), so it is not built; V = 2 and
//   V = 1 serve C % 4 != 0 and tensors that are not 8-byte aligned.
// - Neighbouring threads take neighbouring channel groups, then
//   neighbouring pooled voxels along x, so a warp's access to one child
//   is whole 32-byte sectors, and the other child along x fills the
//   sectors between them.
// - Many short-lived blocks: at V = 4 a block takes one tile (a tile:
//   threads units, a unit one pooled voxel x V channels), at V = 2 two
//   and at V = 1 four in turn; blocks that walked more tiles were slower
//   at every count tried (a thread's next loads wait behind its stores).
//
// The plan (V, the tiles of each block, the grid) is
// kernels/pool2x.py::pool2x_bwd_plan; this file computes none of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const uint16_t* x;
  const uint16_t* g;
  uint16_t* dx;
  int D, H, W, C;
  int groups;   // C / V
  int units;    // a batch item's pooled voxels x groups
  int tiles;    // a batch item's tiles
  int blocks;   // a batch item's blocks (gridDim.x)
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

// V bf16 values as N words (V = 1: one word, its value in the low half)
template <int V>
struct Pack {
  static constexpr int N = V > 1 ? V / 2 : 1;
  uint32_t w[N];
  __device__ __forceinline__ float get(int j) const {
    if (V == 1) return lo_f(w[0]);
    return (j & 1) ? hi_f(w[j >> 1]) : lo_f(w[j >> 1]);
  }
};

template <int V>
__device__ __forceinline__ void load(Pack<V>& r, const uint16_t* p) {
  if constexpr (V == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else if constexpr (V == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

template <int V>
__device__ __forceinline__ void store(uint16_t* p, const Pack<V>& r) {
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  else if constexpr (V == 2)
    *reinterpret_cast<unsigned int*>(p) = r.w[0];
  else
    *p = static_cast<uint16_t>(r.w[0]);
}

// one unit: pooled voxel u / groups of batch item b, channel group
// u % groups
template <int V>
__device__ __forceinline__ void unit(const Args& a, int b, int u) {
  const int hp = a.H >> 1, wp = a.W >> 1;
  const int pv = u / a.groups, cg = u - pv * a.groups;
  const int px = pv % wp, rest = pv / wp, py = rest % hp, pz = rest / hp;
  const int64_t rowc = (int64_t)a.W * a.C, slabc = rowc * a.H;
  const int64_t base = ((int64_t)b * a.D + 2 * pz) * slabc +
                       (2 * py) * rowc + (2 * px) * (int64_t)a.C + cg * V;
  auto child = [&](int k) {  // k = 4 kd + 2 kh + kw
    return base + (k >> 2) * slabc + ((k >> 1) & 1) * rowc + (k & 1) * a.C;
  };
  const int64_t npool = (int64_t)(a.D >> 1) * hp * wp;
  Pack<V> xv[8], gv;
#pragma unroll
  for (int k = 0; k < 8; ++k) load<V>(xv[k], a.x + child(k));
  load<V>(gv, a.g + ((int64_t)b * npool + pv) * a.C + cg * V);
  float m[V], share[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float mx = xv[0].get(j);
    bool nan = mx != mx;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float v = xv[k].get(j);
      nan |= v != v;
      mx = fmaxf(mx, v);
    }
    m[j] = nan ? __int_as_float(0x7fc00000) : mx;
    int ties = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) ties += xv[k].get(j) == m[j];
    share[j] = __fdiv_rn(gv.get(j), (float)ties);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    Pack<V> o;
    if constexpr (V == 1) {
      const float v = xv[k].get(0);
      o.w[0] = pack2(v == m[0] ? share[0] : 0.f, 0.f) & 0xffffu;
    } else {
#pragma unroll
      for (int w = 0; w < Pack<V>::N; ++w) {
        const float lo = xv[k].get(2 * w), hi = xv[k].get(2 * w + 1);
        o.w[w] = pack2(lo == m[2 * w] ? share[2 * w] : 0.f,
                       hi == m[2 * w + 1] ? share[2 * w + 1] : 0.f);
      }
    }
    store<V>(a.dx + child(k), o);
  }
}

// grid (blocks, B): block x of item b walks tiles x * tiles / blocks up to
// (x + 1) * tiles / blocks, thread t taking unit tile * threads + t
template <int V>
__global__ void __launch_bounds__(256, 4) pool2x_bwd_kernel(const Args a) {
  const int b = blockIdx.y, T = blockDim.x;
  const int t0 = (int)((int64_t)blockIdx.x * a.tiles / a.blocks);
  const int t1 = (int)((int64_t)(blockIdx.x + 1) * a.tiles / a.blocks);
  for (int tile = t0; tile < t1; ++tile) {
    const int u = tile * T + threadIdx.x;
    if (u < a.units) unit<V>(a, b, u);
  }
}

}  // namespace

// vec, threads, units, tiles and blocks from kernels/pool2x.py::
// pool2x_bwd_plan: the instances are V = 4, 2, 1 under a launch bound of
// 256 threads, four blocks an SM.
extern "C" int fcd_pool2x_bwd(const void* x, const void* g, void* dx, int B,
                              int D, int H, int W, int C, int vec,
                              int threads, int units, int tiles, int blocks,
                              void* stream) {
  Args a;
  a.x = static_cast<const uint16_t*>(x);
  a.g = static_cast<const uint16_t*>(g);
  a.dx = static_cast<uint16_t*>(dx);
  a.D = D;
  a.H = H;
  a.W = W;
  a.C = C;
  a.groups = C / vec;
  a.units = units;
  a.tiles = tiles;
  a.blocks = blocks;
  if (threads > 256 || threads < 1 || C % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, B);
  if (vec == 4)
    pool2x_bwd_kernel<4><<<grid, threads, 0, s>>>(a);
  else if (vec == 2)
    pool2x_bwd_kernel<2><<<grid, threads, 0, s>>>(a);
  else if (vec == 1)
    pool2x_bwd_kernel<1><<<grid, threads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
