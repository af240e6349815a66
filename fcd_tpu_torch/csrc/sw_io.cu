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
// the exit reads 4O + 4 and writes 4O per output voxel.
//
// The entry is one grid-stride walk over the padded output in units of G
// elements, a unit per thread and step: G floats of the input read as one
// float, float2 or float4 (or G zeros where the unit lies in the pad), and
// the G converted values stored as one access (bf16: 2, 4 or 8 bytes). The
// wrapper picks G (kernels/sw_io.py::entry_group) so that every access is
// aligned and no unit straddles the pad: W C, PW C and the lead pad bw C
// are multiples of G and the tensors 16-byte aligned. At the CLI's C = 2
// that is G = 4 (two voxels a unit) where W, PW and bw are even, else 2
// (one voxel); any other layout takes the general path G = 1. The unit's
// index is divided once into its output row and its place in the row; no
// element divides.
//
// The exit is one grid-stride walk over the cropped volume in units of G
// voxels along x, a unit per thread and step: G * O floats of acc read as
// one float2 or float4, the G coverage values as one float or float2, and
// the G * O products stored with the width they were read with. The
// wrapper picks G (kernels/sw_io.py::exit_group) so that every access is
// aligned: at the engine's O = 2, two voxels (one float4) when W, PW and
// ow are even, else one (a float2). The unit's index is divided once into
// its row and column; no element divides by O. Other O (the model's
// out_channels is 2) and unaligned tensors take the general path: one
// voxel a unit, O scalar loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <int N>
struct FloatVec;
template <>
struct FloatVec<1> {
  typedef float T;
};
template <>
struct FloatVec<2> {
  typedef float2 T;
};
template <>
struct FloatVec<4> {
  typedef float4 T;
};

// N floats read or written as one access
template <int N>
union Floats {
  typename FloatVec<N>::T v;
  float f[N];
};

// two f32 rounded to nearest even into one bf16x2 word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// G values stored as one access of the output type
template <int G>
__device__ __forceinline__ void store_units(float* p, const Floats<G>& v) {
  *reinterpret_cast<typename FloatVec<G>::T*>(p) = v.v;
}

template <int G>
__device__ __forceinline__ void store_units(__nv_bfloat16* p,
                                            const Floats<G>& v) {
  if constexpr (G == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.f[0], v.f[1]),
                                              pack_bf16x2(v.f[2], v.f[3]));
  else if constexpr (G == 2)
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v.f[0], v.f[1]);
  else
    *p = __float2bfloat16_rn(v.f[0]);
}

// units = PD PH PW C / G; row_units = PW C / G; wc_units = W C / G and
// lead_units = bw C / G: the input row and the lead pad in units
template <int G, typename T>
__global__ void __launch_bounds__(NT)
    sw_entry_kernel(const float* __restrict__ in, T* __restrict__ out,
                    unsigned units, unsigned row_units, int wc_units,
                    int lead_units, int D, int H, int PH, int bd, int bh) {
  for (unsigned u = blockIdx.x * NT + threadIdx.x; u < units;
       u += gridDim.x * NT) {
    const unsigned r = u / row_units;   // output row z * PH + y
    const int k = (int)(u - r * row_units) - lead_units;
    const int z = r / PH, y = r - z * PH;
    const int sz = z - bd, sy = y - bh;
    Floats<G> v;
    if (sz >= 0 && sz < D && sy >= 0 && sy < H && k >= 0 && k < wc_units) {
      v.v = *reinterpret_cast<const typename FloatVec<G>::T*>(
          in + (((int64_t)sz * H + sy) * wc_units + k) * G);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) v.f[j] = 0.f;
    }
    store_units<G>(out + (int64_t)u * G, v);
  }
}

// the unit u of the walk: its voxel's index in acc and inv (its output
// starts at u * G * O); w_units = W / G
__device__ __forceinline__ int64_t exit_voxel(unsigned u, unsigned w_units,
                                              int G, int H, int PH, int PW,
                                              int od, int oh, int ow) {
  const unsigned r = u / w_units;   // output row z * H + y
  const unsigned xg = u - r * w_units;
  const int z = r / H, y = r - z * H;
  return ((int64_t)(z + od) * PH + (y + oh)) * PW + ow + (int64_t)xg * G;
}

// G voxels of O floats a unit: G * O floats in one float2 or float4
template <int G, int O>
__global__ void __launch_bounds__(NT)
    sw_exit_kernel(const float* __restrict__ acc, const float* __restrict__ inv,
                   float* __restrict__ out, unsigned units, int H, int W,
                   int PH, int PW, int od, int oh, int ow) {
  constexpr int V = G * O;
  const unsigned w_units = W / G;
  for (unsigned u = blockIdx.x * NT + threadIdx.x; u < units;
       u += gridDim.x * NT) {
    const int64_t pv = exit_voxel(u, w_units, G, H, PH, PW, od, oh, ow);
    Floats<V> a;
    Floats<G> c;
    a.v = *reinterpret_cast<const typename FloatVec<V>::T*>(acc + pv * O);
    c.v = *reinterpret_cast<const typename FloatVec<G>::T*>(inv + pv);
#pragma unroll
    for (int j = 0; j < V; ++j) a.f[j] = __fmul_rn(a.f[j], c.f[j / O]);
    *reinterpret_cast<typename FloatVec<V>::T*>(out + (int64_t)u * V) = a.v;
  }
}

// the general path: one voxel of any O a unit
__global__ void __launch_bounds__(NT)
    sw_exit_kernel_any(const float* __restrict__ acc,
                       const float* __restrict__ inv, float* __restrict__ out,
                       unsigned units, int H, int W, int O, int PH, int PW,
                       int od, int oh, int ow) {
  for (unsigned u = blockIdx.x * NT + threadIdx.x; u < units;
       u += gridDim.x * NT) {
    const int64_t pv = exit_voxel(u, W, 1, H, PH, PW, od, oh, ow);
    const float c = inv[pv];
    const float* a = acc + pv * O;
    float* o = out + (int64_t)u * O;
    for (int j = 0; j < O; ++j) o[j] = __fmul_rn(a[j], c);
  }
}

// a grid-stride walk: at most 8 blocks of NT per SM of an H100
unsigned walk_blocks(unsigned units) {
  return units / NT + 1 < 132 * 8 ? units / NT + 1 : 132 * 8;
}

template <int G, typename T>
int launch_entry(const float* in, T* out, int D, int H, int W, int C, int PD,
                 int PH, int PW, int bd, int bh, int bw, cudaStream_t s) {
  const unsigned units = (unsigned)((int64_t)PD * PH * PW * C / G);
  sw_entry_kernel<G, T><<<walk_blocks(units), NT, 0, s>>>(
      in, out, units, (unsigned)(PW * C / G), W * C / G, bw * C / G, D, H,
      PH, bd, bh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_entry_g(const float* in, T* out, int D, int H, int W, int C,
                   int PD, int PH, int PW, int bd, int bh, int bw, int G,
                   cudaStream_t s) {
  if (G == 4)
    return launch_entry<4, T>(in, out, D, H, W, C, PD, PH, PW, bd, bh, bw, s);
  if (G == 2)
    return launch_entry<2, T>(in, out, D, H, W, C, PD, PH, PW, bd, bh, bw, s);
  if (G == 1)
    return launch_entry<1, T>(in, out, D, H, W, C, PD, PH, PW, bd, bh, bw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// G: elements a unit (kernels/sw_io.py::entry_group)
extern "C" int fcd_sw_entry(const void* in, void* out, int out_bf16, int D,
                            int H, int W, int C, int PD, int PH, int PW,
                            int bd, int bh, int bw, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  if (out_bf16)
    return launch_entry_g(src, static_cast<__nv_bfloat16*>(out), D, H, W, C,
                          PD, PH, PW, bd, bh, bw, G, s);
  return launch_entry_g(src, static_cast<float*>(out), D, H, W, C, PD, PH,
                        PW, bd, bh, bw, G, s);
}

// G: voxels a unit (kernels/sw_io.py::exit_group), 0 for the general path
extern "C" int fcd_sw_exit(const void* acc, const void* inv, void* out, int D,
                           int H, int W, int O, int PH, int PW, int od,
                           int oh, int ow, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* c = static_cast<const float*>(inv);
  float* o = static_cast<float*>(out);
  const unsigned units = (unsigned)D * H * (W / (G > 0 ? G : 1));
  const unsigned blocks = walk_blocks(units);
  if (G == 2 && O == 2)
    sw_exit_kernel<2, 2><<<blocks, NT, 0, s>>>(a, c, o, units, H, W, PH, PW,
                                               od, oh, ow);
  else if (G == 1 && O == 2)
    sw_exit_kernel<1, 2><<<blocks, NT, 0, s>>>(a, c, o, units, H, W, PH, PW,
                                               od, oh, ow);
  else if (G == 0)
    sw_exit_kernel_any<<<blocks, NT, 0, s>>>(a, c, o, units, H, W, O, PH, PW,
                                             od, oh, ow);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
