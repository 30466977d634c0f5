// The port's native host engine: voxel quantization, coordinate hashmaps,
// pyramid levels, kernel maps, and trilinear interpolation tables.
//
// The port's own copy of the JAX package's csrc/coords.cpp, less the
// window-job worklists and the int16 kernel-map wire coder, which serve the
// TPU kernels only. It is the counterpart of MinkowskiEngine's C++
// CoordinateManager (reference: the ME.TensorField/SparseTensor machinery the
// Python side drives at MinkowskiNet/lib/trainer_csn.py:236-258). The device
// never sees dynamic shapes: this library runs on the host per batch and
// emits the static-shape index tables (kernel maps, interp corners) that the
// device path consumes. Exposed as a C ABI for ctypes (no pybind11
// dependency).
//
// Build: csn_tpu_torch/core/native.py compiles it with the host C++ compiler
// at first use into csn_tpu_torch/_build/libcsn_tpu_torch_coords.so.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <algorithm>
#include <vector>

namespace {

struct Level {
  std::vector<int32_t> coords;              // [n, 3]
  std::unordered_map<uint64_t, int32_t> map; // packed coord -> index
  int64_t n = 0;
  // Sorted-key view for merge-join kernel maps (built lazily by
  // csn_shape_kernel_map): skeys ascending, sidx[i] = original index of
  // skeys[i]. Level 0 is already key-sorted at construction (sidx = iota).
  std::vector<uint64_t> skeys;
  std::vector<int32_t> sidx;
  bool sorted_built = false;
  int32_t max_abs_coord = 0;
};

// Pack signed 3D coords into a 64-bit key (21 bits per axis, offset bias).
static inline uint64_t pack(int64_t x, int64_t y, int64_t z) {
  const uint64_t B = 1ull << 20;  // supports coords in (-2^20, 2^20)
  return (((uint64_t)(x + B)) << 42) | (((uint64_t)(y + B)) << 21) |
         ((uint64_t)(z + B));
}

struct Shape {
  std::vector<float> points;   // [n_points, 3] float voxel-unit coords
  int64_t n_points = 0;
  std::vector<Level> levels;
  std::vector<int32_t> p2v;    // point -> level-0 voxel index
};

}  // namespace

extern "C" {

void* csn_shape_create(const float* pts, int64_t n_points, int32_t n_levels) {
  // Fail fast on corrupt input instead of silently corrupting voxelization:
  // a non-finite coordinate hits UB in the float->int64 floor cast, and
  // |c| >= 2^20 voxel units overflows a biased 21-bit key lane so two
  // far-apart points alias to one packed key (wrong p2v/coords/kernel
  // maps). Returns nullptr; the Python wrapper raises with a hint.
  {
    const float LIM = (float)(1ll << 20);
    for (int64_t i = 0; i < n_points * 3; ++i) {
      const float v = pts[i];
      if (!std::isfinite(v) || v >= LIM || v < -LIM) return nullptr;
    }
  }
  Shape* s = new Shape();
  s->n_points = n_points;
  s->points.assign(pts, pts + n_points * 3);
  s->levels.resize(n_levels);
  s->p2v.resize(n_points);

  // Level 0: floor-quantize, then sort voxels lexicographically by
  // (x, y, z), the order of the JAX package's engine (every kernel offset
  // then maps a contiguous output tile into a narrow source-index range).
  // The packed key is lexicographic by construction, so sorting keys ==
  // sorting coords.
  Level& l0 = s->levels[0];
  l0.map.reserve(n_points * 2);
  std::vector<uint64_t> pkeys(n_points);
  for (int64_t i = 0; i < n_points; ++i) {
    int64_t x = (int64_t)std::floor(pts[i * 3 + 0]);
    int64_t y = (int64_t)std::floor(pts[i * 3 + 1]);
    int64_t z = (int64_t)std::floor(pts[i * 3 + 2]);
    pkeys[i] = pack(x, y, z);
  }
  std::vector<uint64_t> uniq(pkeys);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  l0.n = (int64_t)uniq.size();
  l0.coords.resize(l0.n * 3);
  const uint64_t B21 = 1ull << 20;
  const uint64_t M21 = (1ull << 21) - 1;
  for (int64_t j = 0; j < l0.n; ++j) {
    uint64_t key = uniq[j];
    l0.coords[j * 3 + 0] = (int32_t)((key >> 42) & M21) - (int32_t)B21;
    l0.coords[j * 3 + 1] = (int32_t)((key >> 21) & M21) - (int32_t)B21;
    l0.coords[j * 3 + 2] = (int32_t)(key & M21) - (int32_t)B21;
    l0.map.emplace(key, (int32_t)j);
  }
  for (int64_t i = 0; i < n_points; ++i) {
    s->p2v[i] = l0.map.find(pkeys[i])->second;
  }

  // Higher levels: floor-div by 2^l * 2^l, dedup in parent order.
  for (int32_t l = 1; l < n_levels; ++l) {
    Level& prev = s->levels[l - 1];
    Level& cur = s->levels[l];
    int64_t stride = 1ll << l;
    cur.map.reserve(prev.n);
    for (int64_t i = 0; i < prev.n; ++i) {
      int64_t x = prev.coords[i * 3 + 0];
      int64_t y = prev.coords[i * 3 + 1];
      int64_t z = prev.coords[i * 3 + 2];
      auto dv = [stride](int64_t a) {
        // floor division times stride
        int64_t q = a >= 0 ? a / stride : ((a - stride + 1) / stride);
        return q * stride;
      };
      int64_t cx = dv(x), cy = dv(y), cz = dv(z);
      uint64_t key = pack(cx, cy, cz);
      if (cur.map.find(key) == cur.map.end()) {
        cur.map.emplace(key, (int32_t)cur.n);
        cur.coords.push_back((int32_t)cx);
        cur.coords.push_back((int32_t)cy);
        cur.coords.push_back((int32_t)cz);
        cur.n++;
      }
    }
  }
  return s;
}

int64_t csn_shape_num_voxels(void* h, int32_t level) {
  return ((Shape*)h)->levels[level].n;
}

void csn_shape_coords(void* h, int32_t level, int32_t* out, int64_t cap) {
  Shape* s = (Shape*)h;
  Level& l = s->levels[level];
  int64_t n = l.n < cap ? l.n : cap;
  std::memcpy(out, l.coords.data(), n * 3 * sizeof(int32_t));
}

void csn_shape_p2v(void* h, int32_t* out) {
  Shape* s = (Shape*)h;
  std::memcpy(out, s->p2v.data(), s->n_points * sizeof(int32_t));
}

// Kernel map: for each destination voxel (level dst, truncated at cap_dst)
// and each of the K offsets, the source-level voxel index or -1.
// kind: 0=same (src==dst level), 1=down (src=level, dst=level+1),
//       2=up (src=level+1, dst=level). ksize odd -> centered offsets,
// even -> {0..k-1} (ME convention; core/pyramid.py MapSpec.offsets).
void csn_shape_kernel_map(void* h, int32_t kind, int32_t level, int32_t ksize,
                          int64_t cap_dst, int32_t* out) {
  Shape* s = (Shape*)h;
  int32_t src_l, dst_l, sign;
  if (kind == 0) { src_l = level; dst_l = level; sign = 1; }
  else if (kind == 1) { src_l = level; dst_l = level + 1; sign = 1; }
  else { src_l = level + 1; dst_l = level; sign = -1; }

  Level& src = s->levels[src_l];
  Level& dst = s->levels[dst_l];
  int64_t stride = 1ll << level;  // offsets in units of the *finer* level
  int64_t n = dst.n < cap_dst ? dst.n : cap_dst;
  int64_t K = (int64_t)ksize * ksize * ksize;

  std::vector<int64_t> offs(K * 3);
  int64_t lo = (ksize % 2 == 1) ? -(ksize / 2) : 0;
  int64_t idx = 0;
  for (int64_t dx = 0; dx < ksize; ++dx)
    for (int64_t dy = 0; dy < ksize; ++dy)
      for (int64_t dz = 0; dz < ksize; ++dz) {
        offs[idx * 3 + 0] = (lo + dx) * stride;
        offs[idx * 3 + 1] = (lo + dy) * stride;
        offs[idx * 3 + 2] = (lo + dz) * stride;
        idx++;
      }

  // Merge-join fast path: pack() is linear in the coords while every axis
  // field stays inside its 21-bit lane, so the neighbor key of a dst voxel
  // is dst_key + delta with delta = ox<<42 + oy<<21 + oz — a constant
  // shift that preserves sort order. Each offset row then reduces to one
  // two-pointer merge of the (lazily sorted) dst/src key arrays instead of
  // n hash lookups; at bench scale this cut csn_shape_kernel_map from
  // ~150 ms to ~15 ms per 8-shape batch. Guard: coords (plus the largest
  // offset) must stay well clear of the 2^20 lane bias so the per-axis
  // sums can never carry into the neighboring field (a carry would alias a
  // DIFFERENT coordinate, not just miss). Real PartNet geometry is
  // |coord| < 2^12; anything bigger falls back to the hash loop.
  auto build_sorted = [](Level& l) {
    if (l.sorted_built) return;
    l.skeys.resize(l.n);
    l.sidx.resize(l.n);
    int32_t mx = 0;
    for (int64_t j = 0; j < l.n; ++j) {
      l.skeys[j] = pack(l.coords[j * 3], l.coords[j * 3 + 1],
                        l.coords[j * 3 + 2]);
      l.sidx[j] = (int32_t)j;
      for (int64_t a = 0; a < 3; ++a) {
        int32_t c = l.coords[j * 3 + a];
        mx = std::max(mx, c < 0 ? -c : c);
      }
    }
    l.max_abs_coord = mx;
    // level 0 is key-sorted by construction; higher levels are in
    // parent-discovery order and need the argsort
    if (!std::is_sorted(l.skeys.begin(), l.skeys.end())) {
      std::vector<int64_t> ord(l.n);
      for (int64_t j = 0; j < l.n; ++j) ord[j] = j;
      std::sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
        return l.skeys[a] < l.skeys[b];
      });
      std::vector<uint64_t> sk(l.n);
      for (int64_t j = 0; j < l.n; ++j) {
        sk[j] = l.skeys[ord[j]];
        l.sidx[j] = (int32_t)ord[j];
      }
      l.skeys.swap(sk);
    }
    l.sorted_built = true;
  };
  build_sorted(src);
  build_sorted(dst);
  const int64_t max_off = (ksize / 2 + 1) * stride;
  const bool safe = (int64_t)src.max_abs_coord + max_off < (1ll << 19) &&
                    (int64_t)dst.max_abs_coord + max_off < (1ll << 19);

  for (int64_t k = 0; k < K; ++k) {
    int64_t ox = sign * offs[k * 3 + 0];
    int64_t oy = sign * offs[k * 3 + 1];
    int64_t oz = sign * offs[k * 3 + 2];
    int32_t* row = out + k * cap_dst;
    if (safe) {
      std::memset(row, 0xFF, cap_dst * sizeof(int32_t));  // -1
      // unsigned shifts: ox/oy are negative for up-maps and centered
      // kernels, and left-shifting a negative int64 is UB pre-C++20;
      // uint64 wrap gives the identical two's-complement delta.
      const uint64_t delta = ((uint64_t)ox << 42) + ((uint64_t)oy << 21)
                             + (uint64_t)oz;
      const uint64_t* sk = src.skeys.data();
      const int64_t ns = src.n;
      int64_t ps = 0;
      for (int64_t js = 0; js < dst.n; ++js) {
        const uint64_t target = dst.skeys[js] + delta;
        while (ps < ns && sk[ps] < target) ++ps;
        if (ps == ns) break;
        if (sk[ps] == target) {
          const int32_t di = dst.sidx[js];
          if (di < n) row[di] = src.sidx[ps];
        }
      }
      continue;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t x = dst.coords[i * 3 + 0] + ox;
      int64_t y = dst.coords[i * 3 + 1] + oy;
      int64_t z = dst.coords[i * 3 + 2] + oz;
      auto it = src.map.find(pack(x, y, z));
      row[i] = (it == src.map.end()) ? -1 : it->second;
    }
    for (int64_t i = n; i < cap_dst; ++i) row[i] = -1;
  }
}

// Trilinear interpolation tables at level 0: per point, 8 corner voxel
// indices (-1 if absent) and weights.
void csn_shape_interp(void* h, int32_t* idx_out, float* w_out) {
  Shape* s = (Shape*)h;
  Level& l0 = s->levels[0];
  for (int64_t i = 0; i < s->n_points; ++i) {
    double px = s->points[i * 3 + 0];
    double py = s->points[i * 3 + 1];
    double pz = s->points[i * 3 + 2];
    int64_t bx = (int64_t)std::floor(px);
    int64_t by = (int64_t)std::floor(py);
    int64_t bz = (int64_t)std::floor(pz);
    double fx = px - bx, fy = py - by, fz = pz - bz;
    int64_t c = 0;
    for (int64_t dx = 0; dx <= 1; ++dx)
      for (int64_t dy = 0; dy <= 1; ++dy)
        for (int64_t dz = 0; dz <= 1; ++dz) {
          auto it = l0.map.find(pack(bx + dx, by + dy, bz + dz));
          double w = (dx ? fx : 1.0 - fx) * (dy ? fy : 1.0 - fy) *
                     (dz ? fz : 1.0 - fz);
          if (it == l0.map.end()) {
            idx_out[i * 8 + c] = -1;
            w_out[i * 8 + c] = 0.0f;
          } else {
            idx_out[i * 8 + c] = it->second;
            w_out[i * 8 + c] = (float)w;
          }
          c++;
        }
  }
}

void csn_shape_destroy(void* h) { delete (Shape*)h; }

// Kernel-map globalization (core/pyramid.py fill_shape): rewrite a
// per-shape local [K, Ld] table (entries in [0, n_src) valid, anything
// else missing) into the batch-global column block out[:, b*Ld:(b+1)*Ld]
// as add + v (add = b*Ls) with sentinel `sent` (= B*Ls) for missing.
// One fused pass where the numpy form ((>=0)&(<n_src) masks + np.where +
// astype + slice assign) walks the batch tables four times. `out` points at
// column b*Ld of the batch table; row_stride is its full width (B*Ld).
void csn_globalize_kmap(const int32_t* local, int64_t K, int64_t Ld,
                        int64_t n_src, int64_t add, int32_t sent,
                        int32_t* out, int64_t row_stride) {
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* lr = local + k * Ld;
    int32_t* orow = out + k * row_stride;
    for (int64_t i = 0; i < Ld; ++i) {
      const int32_t v = lr[i];
      // (v >= 0 && v < n_src) as one unsigned compare
      orow[i] = ((uint32_t)v < (uint64_t)n_src) ? (int32_t)(add + v) : sent;
    }
  }
}

}  // extern "C"
