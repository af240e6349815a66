// The sliding-window engine's volume entry and blend exit (Hopper, sm_90a).
//
// sw_entry replaces fcd_tpu/kernels/s2d_entry.py::s2d_entry (B17): the raw
// (D, H, W, C) f32 volume becomes the engine's padded compute-dtype volume,
//
//   out[z, y, x, c] = cast(in[z - bd, y - bh, x - bw, c]) inside, 0 outside,
//
// of shape (PD, PH, PW, C), with the symmetric zero pad up to the roi
// (bd = pad // 2 before, the rest after) and the cast to bf16 (round to
// nearest even, as torch's .to(bfloat16)) or f32, in one pass. The TPU
// kernel's space-to-depth lanes exist only to fill the TPU's 128-lane unit
// and have no counterpart here.
//
// sw_exit replaces fcd_tpu/kernels/d2s_exit.py::d2s_exit_flat (B6): the
// blend accumulator (PD, PH, PW, O) f32 times the reciprocal coverage
// (PD, PH, PW, 1) f32, cropped at (od, oh, ow) to (D, H, W, O) and written
// contiguous, so the flat (D, H, W*O) volume is a view of it. One f32
// multiply per element, so it is bit-equal to `acc * inv` in PyTorch.
//
// What bounds both: bytes. Neither does more than one operation per
// element: the entry reads 4C bytes and writes 2C (bf16) per padded voxel,
// the exit reads 4O + 4 and writes 4O per output voxel. The design gives
// each block one output row (z, y), walked by the threads along x * C (or
// x * O): a row of the output is one contiguous run, and so is the input
// row it reads, so neighbouring threads touch neighbouring addresses and
// the only index arithmetic per element is an add and a compare (the exit
// adds one division by O for the coverage's index).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    sw_entry_kernel(const float* __restrict__ in, T* __restrict__ out, int D,
                    int H, int W, int C, int PH, int PW, int bd, int bh,
                    int bw) {
  const int z = blockIdx.z, y = blockIdx.y;
  const int sz = z - bd, sy = y - bh;
  const bool row = sz >= 0 && sz < D && sy >= 0 && sy < H;
  const int n = PW * C, wc = W * C, lead = bw * C;
  T* orow = out + ((int64_t)z * PH + y) * n;
  const float* irow = in + ((int64_t)(row ? sz : 0) * H + (row ? sy : 0)) * wc;
  for (int j = blockIdx.x * NT + threadIdx.x; j < n; j += gridDim.x * NT) {
    const int k = j - lead;
    orow[j] = from_f32<T>(row && k >= 0 && k < wc ? irow[k] : 0.f);
  }
}

__global__ void __launch_bounds__(NT)
    sw_exit_kernel(const float* __restrict__ acc, const float* __restrict__ inv,
                   float* __restrict__ out, int H, int W, int O, int PH,
                   int PW, int od, int oh, int ow) {
  const int z = blockIdx.z, y = blockIdx.y;
  const int n = W * O;
  const int64_t pv = ((int64_t)(z + od) * PH + (y + oh)) * PW + ow;
  const float* arow = acc + pv * O;
  const float* crow = inv + pv;
  float* orow = out + ((int64_t)z * H + y) * n;
  for (int j = blockIdx.x * NT + threadIdx.x; j < n; j += gridDim.x * NT)
    orow[j] = __fmul_rn(arow[j], crow[j / O]);
}

dim3 rows_grid(int n, int rows_y, int rows_z) {
  return dim3((n + NT - 1) / NT, rows_y, rows_z);
}

}  // namespace

extern "C" int fcd_sw_entry(const void* in, void* out, int out_bf16, int D,
                            int H, int W, int C, int PD, int PH, int PW,
                            int bd, int bh, int bw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = rows_grid(PW * C, PH, PD);
  const float* src = static_cast<const float*>(in);
  if (out_bf16)
    sw_entry_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), D, H, W, C, PH, PW, bd, bh,
        bw);
  else
    sw_entry_kernel<float><<<grid, NT, 0, s>>>(
        src, static_cast<float*>(out), D, H, W, C, PH, PW, bd, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fcd_sw_exit(const void* acc, const void* inv, void* out, int D,
                           int H, int W, int O, int PH, int PW, int od,
                           int oh, int ow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = rows_grid(W * O, H, D);
  sw_exit_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(acc), static_cast<const float*>(inv),
      static_cast<float*>(out), H, W, O, PH, PW, od, oh, ow);
  return static_cast<int>(cudaGetLastError());
}
