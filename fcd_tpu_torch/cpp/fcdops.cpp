// Native post-processing ops for fcd_tpu.
//
// TPU-native replacement for the compiled deps the reference leans on in
// its eval path: cc3d's Cython connected components (metrics.py:209-214)
// and scipy.ndimage's C morphology (utils/utils_common.py:14-16).
// Exposed via a C ABI consumed through ctypes (fcd_tpu/postproc/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC fcdops.cpp -o libfcdops.so

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Disjoint-set with path halving.
struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int64_t>(i);
  }
  int64_t find(int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a < b) parent[b] = a;
    else if (b < a) parent[a] = b;
  }
};

}  // namespace

extern "C" {

// 26/18/6-connected components of a binary mask (uint8), labels out int32.
// Two-pass union-find over backward neighbours. Labels are assigned in
// raster-scan order of first appearance (cc3d-compatible numbering).
// Returns the number of components.
int64_t connected_components_3d(const uint8_t* mask, int64_t d, int64_t h,
                                int64_t w, int32_t connectivity,
                                int32_t* labels) {
  const int64_t n = d * h * w;
  // backward neighbour offsets (strictly earlier in raster order)
  std::vector<std::array<int, 3>> offs;
  for (int dz = -1; dz <= 0; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
        int manh = (dz != 0) + (dy != 0) + (dx != 0);
        if (connectivity == 6 && manh > 1) continue;
        if (connectivity == 18 && manh > 2) continue;
        offs.push_back({dz, dy, dx});
      }

  std::vector<int64_t> provisional(n, -1);
  UnionFind uf(0);
  std::vector<int64_t> uf_parent;  // grow lazily
  auto uf_find = [&uf_parent](int64_t x) {
    while (uf_parent[x] != x) {
      uf_parent[x] = uf_parent[uf_parent[x]];
      x = uf_parent[x];
    }
    return x;
  };
  auto uf_unite = [&uf_parent, &uf_find](int64_t a, int64_t b) {
    a = uf_find(a);
    b = uf_find(b);
    if (a < b) uf_parent[b] = a;
    else if (b < a) uf_parent[a] = b;
  };

  int64_t next = 0;
  for (int64_t z = 0; z < d; ++z) {
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        const int64_t i = (z * h + y) * w + x;
        if (!mask[i]) continue;
        int64_t lab = -1;
        for (const auto& o : offs) {
          const int64_t zz = z + o[0], yy = y + o[1], xx = x + o[2];
          if (zz < 0 || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
          const int64_t j = (zz * h + yy) * w + xx;
          if (!mask[j]) continue;
          const int64_t pl = provisional[j];
          if (lab == -1) lab = pl;
          else if (pl != lab) uf_unite(lab, pl);
        }
        if (lab == -1) {
          lab = next++;
          uf_parent.push_back(lab);
        }
        provisional[i] = lab;
      }
    }
  }

  // second pass: map roots to consecutive labels in first-appearance order
  std::vector<int32_t> root_to_label(next, 0);
  int32_t n_comp = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (provisional[i] < 0) {
      labels[i] = 0;
      continue;
    }
    const int64_t r = uf_find(provisional[i]);
    if (root_to_label[r] == 0) root_to_label[r] = ++n_comp;
    labels[i] = root_to_label[r];
  }
  return n_comp;
}

// Binary dilation with a centered box structuring element of radius r
// (size 2r+1 per axis), `iterations` times. In-place friendly via buffers.
void binary_dilate_box(const uint8_t* mask, int64_t d, int64_t h, int64_t w,
                       int32_t radius, int32_t iterations, uint8_t* out) {
  const int64_t n = d * h * w;
  std::vector<uint8_t> cur(mask, mask + n), tmp(n);
  // separable: box dilation = 1D max filter along each axis
  for (int it = 0; it < iterations; ++it) {
    for (int axis = 0; axis < 3; ++axis) {
      const int64_t dims[3] = {d, h, w};
      const int64_t strides[3] = {h * w, w, 1};
      const int64_t len = dims[axis], stride = strides[axis];
      const int64_t outer = n / len;
      std::fill(tmp.begin(), tmp.end(), 0);
      for (int64_t o = 0; o < outer; ++o) {
        // compute base index of this line
        int64_t base;
        if (axis == 0) base = o % (h * w);
        else if (axis == 1) base = (o / w) * (h * w) + (o % w);
        else base = o * w;
        for (int64_t i = 0; i < len; ++i) {
          if (!cur[base + i * stride]) continue;
          const int64_t lo = i - radius < 0 ? 0 : i - radius;
          const int64_t hi = i + radius >= len ? len - 1 : i + radius;
          for (int64_t j = lo; j <= hi; ++j) tmp[base + j * stride] = 1;
        }
      }
      cur.swap(tmp);
    }
  }
  std::memcpy(out, cur.data(), n);
}

// Binary erosion / dilation with an arbitrary structuring element
// (uint8 cube of size (2rz+1, 2ry+1, 2rx+1)), matching scipy semantics
// (out-of-bounds treated as 0 for dilation, as 0 for erosion -> border erodes).
void binary_morph(const uint8_t* mask, int64_t d, int64_t h, int64_t w,
                  const uint8_t* structure, int32_t rz, int32_t ry, int32_t rx,
                  int32_t iterations, int32_t is_erosion, uint8_t* out) {
  const int64_t n = d * h * w;
  std::vector<uint8_t> cur(mask, mask + n), nxt(n);
  const int64_t sh = 2 * ry + 1, sw = 2 * rx + 1;
  std::vector<std::array<int, 3>> offs;
  for (int z = -rz; z <= rz; ++z)
    for (int y = -ry; y <= ry; ++y)
      for (int x = -rx; x <= rx; ++x)
        if (structure[((z + rz) * sh + (y + ry)) * sw + (x + rx)])
          offs.push_back({z, y, x});

  for (int it = 0; it < iterations; ++it) {
    for (int64_t z = 0; z < d; ++z)
      for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x) {
          const int64_t i = (z * h + y) * w + x;
          uint8_t v;
          if (is_erosion) {
            v = 1;
            for (const auto& o : offs) {
              const int64_t zz = z + o[0], yy = y + o[1], xx = x + o[2];
              if (zz < 0 || zz >= d || yy < 0 || yy >= h || xx < 0 || xx >= w ||
                  !cur[(zz * h + yy) * w + xx]) {
                v = 0;
                break;
              }
            }
          } else {
            v = 0;
            for (const auto& o : offs) {
              const int64_t zz = z + o[0], yy = y + o[1], xx = x + o[2];
              if (zz >= 0 && zz < d && yy >= 0 && yy < h && xx >= 0 && xx < w &&
                  cur[(zz * h + yy) * w + xx]) {
                v = 1;
                break;
              }
            }
          }
          nxt[i] = v;
        }
    cur.swap(nxt);
  }
  std::memcpy(out, cur.data(), n);
}

// Fill holes: background flood fill (6-connected through the *dilated
// complement* reachable from the volume border, using structuring element
// semantics of scipy.ndimage.binary_fill_holes(structure)): a voxel is a
// hole iff it is background and NOT reachable from the border through
// background via the structuring element's connectivity.
void binary_fill_holes(const uint8_t* mask, int64_t d, int64_t h, int64_t w,
                       const uint8_t* structure, int32_t rz, int32_t ry,
                       int32_t rx, uint8_t* out) {
  const int64_t n = d * h * w;
  const int64_t sh = 2 * ry + 1, sw = 2 * rx + 1;
  std::vector<std::array<int, 3>> offs;
  for (int z = -rz; z <= rz; ++z)
    for (int y = -ry; y <= ry; ++y)
      for (int x = -rx; x <= rx; ++x) {
        if (z == 0 && y == 0 && x == 0) continue;
        if (structure[((z + rz) * sh + (y + ry)) * sw + (x + rx)])
          offs.push_back({z, y, x});
      }

  std::vector<uint8_t> reach(n, 0);
  std::vector<int64_t> stack;
  stack.reserve(1 << 16);
  // seed: all border background voxels
  for (int64_t z = 0; z < d; ++z)
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        if (z != 0 && z != d - 1 && y != 0 && y != h - 1 && x != 0 && x != w - 1)
          continue;
        const int64_t i = (z * h + y) * w + x;
        if (!mask[i] && !reach[i]) {
          reach[i] = 1;
          stack.push_back(i);
        }
      }
  while (!stack.empty()) {
    const int64_t i = stack.back();
    stack.pop_back();
    const int64_t z = i / (h * w), y = (i / w) % h, x = i % w;
    for (const auto& o : offs) {
      const int64_t zz = z + o[0], yy = y + o[1], xx = x + o[2];
      if (zz < 0 || zz >= d || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const int64_t j = (zz * h + yy) * w + xx;
      if (!mask[j] && !reach[j]) {
        reach[j] = 1;
        stack.push_back(j);
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) out[i] = mask[i] || !reach[i];
}

// Component sizes for an int32 label volume: sizes[l] = count of voxels with
// label l, for l in [0, n_labels].
void component_sizes(const int32_t* labels, int64_t n, int64_t n_labels,
                     int64_t* sizes) {
  std::memset(sizes, 0, sizeof(int64_t) * (n_labels + 1));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t l = labels[i];
    if (l >= 0 && l <= n_labels) ++sizes[l];
  }
}

}  // extern "C"

namespace {

constexpr double kInf = 1e30;

// Felzenszwalb-Huttenlocher 1D squared distance transform with anisotropic
// voxel pitch `w`: d[p] = min_q ((p-q)^2 w^2 + f[q]). Parabolas with f = kInf
// are excluded from the lower envelope (rows with no seed stay at kInf).
void dt1d(const double* f, double* d, int* v, double* z, int n, double w) {
  int k = -1;
  const double w2 = w * w;
  for (int q = 0; q < n; ++q) {
    if (f[q] >= kInf) continue;
    double s;
    for (;;) {
      if (k < 0) {
        s = -kInf;
        break;
      }
      const int p = v[k];
      // intersection of parabola q with parabola v[k]
      s = ((f[q] + w2 * q * q) - (f[p] + w2 * p * p)) /
          (2.0 * w2 * (q - p));
      if (s > z[k]) break;
      --k;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    if (k + 1 < n + 1) z[k + 1] = kInf;
  }
  if (k < 0) {  // no finite parabola on this line
    for (int p = 0; p < n; ++p) d[p] = kInf;
    return;
  }
  int j = 0;
  for (int p = 0; p < n; ++p) {
    while (j < k && z[j + 1] < p) ++j;
    const double dp = w * (p - v[j]);
    d[p] = dp * dp + f[v[j]];
  }
}

}  // namespace

extern "C" {

// Exact Euclidean distance transform (scipy.ndimage.distance_transform_edt
// semantics): for every voxel where mask != 0, the distance to the nearest
// zero voxel, with per-axis sampling (sz, sy, sx); zero voxels map to 0.
// Returns 0 on success, 1 if the mask has no zero voxel (out = inf-like).
int32_t edt_3d(const uint8_t* mask, int64_t d, int64_t h, int64_t w,
               double sz, double sy, double sx, double* out) {
  const int64_t n = d * h * w;
  std::vector<double> g(n);
  for (int64_t i = 0; i < n; ++i) g[i] = mask[i] ? kInf : 0.0;

  const int nmax = static_cast<int>(d > h ? (d > w ? d : w) : (h > w ? h : w));
  std::vector<double> f(nmax), dd(nmax), z(nmax + 1);
  std::vector<int> v(nmax);

  // axis 2 (x): contiguous rows
  for (int64_t zz = 0; zz < d; ++zz)
    for (int64_t yy = 0; yy < h; ++yy) {
      double* row = g.data() + (zz * h + yy) * w;
      dt1d(row, dd.data(), v.data(), z.data(), static_cast<int>(w), sx);
      std::memcpy(row, dd.data(), sizeof(double) * w);
    }
  // axis 1 (y)
  for (int64_t zz = 0; zz < d; ++zz)
    for (int64_t xx = 0; xx < w; ++xx) {
      double* base = g.data() + zz * h * w + xx;
      for (int64_t yy = 0; yy < h; ++yy) f[yy] = base[yy * w];
      dt1d(f.data(), dd.data(), v.data(), z.data(), static_cast<int>(h), sy);
      for (int64_t yy = 0; yy < h; ++yy) base[yy * w] = dd[yy];
    }
  // axis 0 (z)
  bool any_zero = false;
  for (int64_t yy = 0; yy < h; ++yy)
    for (int64_t xx = 0; xx < w; ++xx) {
      double* base = g.data() + yy * w + xx;
      for (int64_t zz = 0; zz < d; ++zz) f[zz] = base[zz * h * w];
      dt1d(f.data(), dd.data(), v.data(), z.data(), static_cast<int>(d), sz);
      for (int64_t zz = 0; zz < d; ++zz) base[zz * h * w] = dd[zz];
    }

  for (int64_t i = 0; i < n; ++i) {
    if (g[i] < kInf) {
      out[i] = std::sqrt(g[i]);
      any_zero = true;
    } else {
      out[i] = kInf;
    }
  }
  return any_zero ? 0 : 1;
}

// 2x2x2 neighbour-code correlation (scipy.ndimage.correlate with the
// surface-distance bit kernel [[[128,64],[32,16]],[[8,4],[2,1]]], constant-0
// padding, even-kernel origin at index 1 per axis):
//   code[z,y,x] = sum_{dz,dy,dx in {0,1}} mask[z+dz-1, y+dy-1, x+dx-1]
//                 * K[dz,dy,dx]
void neighbour_code_3d(const uint8_t* mask, int64_t d, int64_t h, int64_t w,
                       uint8_t* code) {
  static const int kBits[2][2][2] = {{{128, 64}, {32, 16}}, {{8, 4}, {2, 1}}};
  for (int64_t z = 0; z < d; ++z)
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        int c = 0;
        for (int dz = 0; dz < 2; ++dz) {
          const int64_t zz = z + dz - 1;
          if (zz < 0 || zz >= d) continue;
          for (int dy = 0; dy < 2; ++dy) {
            const int64_t yy = y + dy - 1;
            if (yy < 0 || yy >= h) continue;
            for (int dx = 0; dx < 2; ++dx) {
              const int64_t xx = x + dx - 1;
              if (xx < 0 || xx >= w) continue;
              if (mask[(zz * h + yy) * w + xx]) c += kBits[dz][dy][dx];
            }
          }
        }
        code[(z * h + y) * w + x] = static_cast<uint8_t>(c);
      }
}

}  // extern "C"
