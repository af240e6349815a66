// The finishing pass of B1's row-parallel split (Hopper, sm_90a).
//
// Under tensor parallelism (fcd_tpu/parallel/tp.py) a row-parallel 3x3x3
// conv runs B1's partial instance (csrc/conv3d.cu, fcd_conv3d_partial) on
// each rank's slice of the input channels; the ranks' f32 partials are
// summed by an all-reduce, and this pass finishes the sum s as B1's
// epilogue finishes its accumulators on one device (the Pallas kernel it
// stands beside is fcd_tpu/kernels/block_conv.py::_fused8_call):
//
//   y[b, v, c]   = bf16(s[b, v, c])           (round to nearest even)
//   sum[b, c]    = sum_v s[b, v, c]           (f32, before the rounding)
//   sumsq[b, c]  = sum_v s[b, v, c]^2
//
// The statistics are taken from the summed f32 values: the sum of the
// ranks' partial squares is not the square of their sum, so they are never
// all-reduced in place of the output.
//
// What bounds it: bytes. It reads 4 and writes 2 bytes an element, 6 in
// all (at enc1's 1 x 128^3 x 16 that is 192 MiB: 0.0601 ms at 3.35 TB/s),
// and does three f32 operations an element.
//
// Design. One streaming kernel, `conv_finish_bulk_kernel`: a block takes
// a contiguous run of voxels of one batch item and streams it through a
// ring of STAGES (8) chunks of up to 16 KB in shared memory, filled by
// bulk copies (cp.async.bulk, the TMA's one-dimensional form) that one
// thread starts against an mbarrier a stage: 128 KB in flight a block, one
// block an SM. A thread owns 4 channels: it reads one float4 a voxel from
// the ring and writes four bf16 in one 8-byte store; the threads lie
// channel group fastest, so a warp stores 256 contiguous bytes. Each
// thread keeps the running sums of its 4 channels in registers, and the
// block adds its threads' rows in a fixed binary tree through shared
// memory. No atomics anywhere, so two calls give the same bits (ROADMAP
// C9). Two plans (the wrapper's `finish_plan` picks one by the size):
// - Up to 2^18 elements a batch item (levels 4-6 at fs16), one launch:
//   the blocks of a batch item form one thread-block cluster of up to 16,
//   and rank 0 adds the blocks' rows through distributed shared memory in
//   block-rank order, so no second pass and no atomic ticket is needed.
// - Above it, two launches: about 132 blocks (one an SM) write one
//   partial row each, and `conv_finish_sum_kernel` adds the rows in run
//   order (fixed chunks, then a fixed tree).
// Why the threshold: a cluster's blocks share one GPC, and there they read
// about 45 GB/s an SM on an H100 whatever the loads (plain float4 loads
// and bulk copies alike), so a cluster streams at most about 0.7 TB/s. At
// level 3 (6 MB) one launch took 0.0097 ms against 0.0060 ms for two
// launches over the whole card; up to 1 MB one launch matches or beats two
// (`python -m fcd_tpu_torch.kernels.finish_sweep --plans`, H100 80GB HBM3
// at 700 W).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT_BULK = 512;      // threads a block, the streaming kernel
constexpr int NT_SUM = 256;       // threads a block, the run sum
constexpr int STAGES = 8;         // chunks in flight a block
constexpr int CHUNK = 16384;      // bytes a chunk at most
constexpr int RING = STAGES * CHUNK;
constexpr int MAX_CLUSTER = 16;   // non-portable above 8
constexpr int MAX_C = 1024;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// y's four bf16 of t (round to nearest even) in one 8-byte store, and t
// added to the running sums a and q.
__device__ __forceinline__ void finish4(const float4& t, uint2* at, float4& a,
                                        float4& q) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(t.x, t.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(t.z, t.w);
  uint2 word;
  word.x = *reinterpret_cast<const uint32_t*>(&lo);
  word.y = *reinterpret_cast<const uint32_t*>(&hi);
  *at = word;
  add4(a, t);
  q.x += t.x * t.x;
  q.y += t.y * t.y;
  q.z += t.z * t.z;
  q.w += t.w * t.w;
}

// Rows [0, rows) of the (rows, g) float4 arrays r1 and r2 summed into row
// 0 in a fixed tree: at step h, row i < h adds row i + h. Every thread of
// the block calls it; (tc, tr) is the caller's column and row.
__device__ __forceinline__ void tree_rows(float4* r1, float4* r2, int rows,
                                          int g, int tc, int tr,
                                          bool active) {
  int p = 1;
  while (p < rows) p <<= 1;
  for (int h = p >> 1; h > 0; h >>= 1) {
    if (active && tr < h && tr + h < rows) {
      const int i = tr * g + tc, j = (tr + h) * g + tc;
      add4(r1[i], r1[j]);
      add4(r2[i], r2[j]);
    }
    __syncthreads();
  }
}

// The block's threads' sums (rb rows of g columns) added in the fixed tree
// through `red` (2 * rb * g float4) and written. Without a cluster the
// block writes its row at (run, b) of (runs, B, g); with one, rank 0 adds
// the blocks' rows in rank order and writes them at (run / size, b).
template <bool CLUSTER>
__device__ __forceinline__ void block_sums(float4* red, const float4& a,
                                           const float4& q, int rb, int g,
                                           int tc, int tr, bool active,
                                           float4* out_sum, float4* out_sq) {
  const int b = blockIdx.y, nb = gridDim.y;
  float4* r1 = red;
  float4* r2 = red + rb * g;
  if (active) {
    r1[tr * g + tc] = a;
    r2[tr * g + tc] = q;
  }
  __syncthreads();
  tree_rows(r1, r2, rb, g, tc, tr, active);
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (cl.block_rank() == 0) {
      const unsigned n = cl.num_blocks();
      for (int c = threadIdx.x; c < g; c += blockDim.x) {
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f), Q = A;
        for (unsigned r = 0; r < n; ++r) {
          add4(A, cl.map_shared_rank(r1, r)[c]);
          add4(Q, cl.map_shared_rank(r2, r)[c]);
        }
        const size_t at = ((size_t)(blockIdx.x / n) * nb + b) * g + c;
        out_sum[at] = A;
        out_sq[at] = Q;
      }
    }
    cl.sync();  // no block leaves while rank 0 reads its shared memory
  } else {
    for (int c = threadIdx.x; c < g; c += blockDim.x) {
      const size_t at = ((size_t)blockIdx.x * nb + b) * g + c;
      out_sum[at] = r1[c];
      out_sq[at] = r2[c];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1)
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t at = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Chunk k (of cv voxels, the last one short) of a run of n voxels at src
// into stage k % STAGES of the ring, completing on that stage's barrier.
__device__ __forceinline__ void load_chunk(int k, float4* ring,
                                            uint64_t* full, const float* src,
                                            int n, int cv, int C) {
  const int st = k % STAGES;
  const uint32_t bytes = (uint32_t)min(cv, n - k * cv) * C * 4;
  bar_expect(&full[st], bytes);
  bulk_load(ring + (size_t)st * (CHUNK / 16), src + (size_t)k * cv * C, bytes,
            &full[st]);
}

// Block (run, b) streams voxels [run * rows, (run + 1) * rows) of batch
// item b, which lie contiguous in s (f32 (B, nvox, C)), through the ring:
// chunk k of cv voxels goes to stage k % STAGES; thread 0 starts it and,
// once every thread has finished with chunk k, chunk k + STAGES into the
// same stage. Thread (tc, tr) takes rows tr, tr + rb, ... of each chunk,
// in chunk order. Then `block_sums` (the cluster's, or a partial row).
template <bool CLUSTER>
__global__ void __launch_bounds__(NT_BULK, 1)
    conv_finish_bulk_kernel(const float* __restrict__ s,
                            uint2* __restrict__ y,
                            float4* __restrict__ out_sum,
                            float4* __restrict__ out_sq, int nvox, int C,
                            int rows) {
  extern __shared__ __align__(128) float4 ring[];  // STAGES chunks
  __shared__ float4 red[2 * NT_BULK];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int g = C / 4, rb = NT_BULK / g;
  const int tc = threadIdx.x % g, tr = threadIdx.x / g;
  const bool active = tr < rb;
  const long long v0 = (long long)blockIdx.x * rows;
  const int n = (int)max(0LL, min((long long)nvox, v0 + rows) - v0);
  const int cv = max(1, CHUNK / (C * 4));  // voxels a chunk
  const int chunks = (n + cv - 1) / cv;
  const float* src = s + ((size_t)blockIdx.y * nvox + v0) * C;
  uint2* dst = y + ((size_t)blockIdx.y * nvox + v0) * g + tc;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) bar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(STAGES, chunks); ++k)
      load_chunk(k, ring, full, src, n, cv, C);
  }
  __syncthreads();
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), q = a;
  for (int k = 0; k < chunks; ++k) {
    const int st = k % STAGES;
    bar_wait(&full[st], (k / STAGES) & 1);
    const int m = min(cv, n - k * cv);
    const float4* buf = ring + (size_t)st * (CHUNK / 16);
    if (active)
      for (int r = tr; r < m; r += rb)
        finish4(buf[r * g + tc], dst + ((size_t)k * cv + r) * g, a, q);
    __syncthreads();  // the stage is free again
    if (threadIdx.x == 0 && k + STAGES < chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_chunk(k + STAGES, ring, full, src, n, cv, C);
    }
  }
  block_sums<CLUSTER>(red, a, q, rb, g, tc, tr, active, out_sum, out_sq);
}

// The large grids' second pass: p1, p2 (runs, B, g) float4 partial rows ->
// o1, o2 (B, g). Block (x, b) takes channel groups [x * gb, (x + 1) * gb);
// thread row tr adds runs tr, tr + rb, ... in order, then a fixed tree.
__global__ void __launch_bounds__(NT_SUM)
    conv_finish_sum_kernel(const float4* __restrict__ p1,
                           const float4* __restrict__ p2,
                           float4* __restrict__ o1, float4* __restrict__ o2,
                           int runs, int g, int gb) {
  __shared__ float4 red[2 * NT_SUM];
  const int rb = NT_SUM / gb;
  const int tc = threadIdx.x % gb, tr = threadIdx.x / gb;
  const int c = blockIdx.x * gb + tc, b = blockIdx.y, nb = gridDim.y;
  const bool active = tr < rb && c < g;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), q = a;
  if (active) {
    for (int r = tr; r < runs; r += rb) {
      const size_t at = ((size_t)r * nb + b) * g + c;
      add4(a, p1[at]);
      add4(q, p2[at]);
    }
  }
  float4* r1 = red;
  float4* r2 = red + rb * gb;
  if (active) {
    r1[tr * gb + tc] = a;
    r2[tr * gb + tc] = q;
  }
  __syncthreads();
  tree_rows(r1, r2, rb, gb, tc, tr, active);
  if (tr == 0 && c < g) {
    o1[(size_t)b * g + c] = r1[tc];
    o2[(size_t)b * g + c] = r2[tc];
  }
}

// The bulk kernel's launch: its shared memory, and clusters above 8.
template <bool CLUSTER>
cudaError_t bulk_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        dim3 grid, int cluster, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_finish_bulk_kernel<CLUSTER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(conv_finish_bulk_kernel<CLUSTER>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT_BULK);
  cfg.dynamicSmemBytes = RING;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return e;
}

}  // namespace

// s: f32 (B, nvox, C), C a multiple of 4 up to 1024, 16-byte aligned; y:
// bf16, the same shape, 8-byte aligned; sum, sq: f32 (B, C). `rows` voxels
// a block, `runs` blocks a batch item. cluster > 0 (then equal to runs, at
// most 16): one launch, the runs one cluster. cluster == 0: the runs' rows
// go to part, f32 (2, runs, B, C), and a second launch adds them.
extern "C" int fcd_conv_finish(const float* s, void* y, float* sum,
                               float* sq, float* part, int B, int nvox,
                               int C, int rows, int runs, int cluster,
                               void* stream) {
  if (C < 4 || C % 4 || C > MAX_C || B < 1 || nvox < 1 || rows < 1 ||
      runs < 1 || cluster < 0 || cluster > MAX_CLUSTER ||
      (cluster > 0 && cluster != runs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = C / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint2* y8 = static_cast<uint2*>(y);
  float4* sum4 = reinterpret_cast<float4*>(sum);
  float4* sq4 = reinterpret_cast<float4*>(sq);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e;
  if (cluster > 0) {
    e = bulk_config<true>(cfg, attr, dim3(runs, B), cluster, st);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, conv_finish_bulk_kernel<true>, s, y8,
                             sum4, sq4, nvox, C, rows);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  float4* p1 = reinterpret_cast<float4*>(part);
  float4* p2 = p1 + (size_t)runs * B * g;
  e = bulk_config<false>(cfg, attr, dim3(runs, B), 0, st);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, conv_finish_bulk_kernel<false>, s, y8, p1,
                           p2, nvox, C, rows);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gb = g < 32 ? g : 32;
  conv_finish_sum_kernel<<<dim3((g + gb - 1) / gb, B), NT_SUM, 0, st>>>(
      p1, p2, sum4, sq4, runs, g, gb);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks of the kernel the card can hold at
// once (cudaOccupancyMaxActiveClusters): 0 where it cannot place one;
// minus the CUDA error on failure.
extern "C" int fcd_conv_finish_max_clusters(int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = bulk_config<true>(cfg, attr, dim3(cluster, 1), cluster, 0);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, conv_finish_bulk_kernel<true>,
                                       &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return n;
}
