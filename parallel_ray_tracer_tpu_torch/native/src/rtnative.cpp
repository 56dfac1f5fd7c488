// Copy of parallel_ray_tracer_tpu/native/src/rtnative.cpp, the PyTorch
// port's native host runtime: OBJ/MTL/light parsing + BVH build/flatten/pack.
// The code is the JAX package's, line for line, so that both packages build
// the same trees from the same triangles.
//
// C++ counterpart of the reference's host-side C layer (cpu/src/triangle.c,
// cpu/src/bvh.c, duplicated at gpu/src/{triangle,bvh}.cu): the scene loader
// implements the same OBJ/MTL subset ('v'/'f'/'usemtl'; newmtl with Kd/Ks/Kr
// within the next 5 lines, <=128 materials; lights as 'x y z r g b' rows),
// and the builder implements the same 7 split heuristics, leaf rules, and
// node semantics as the Python builder (ops/bvh.py), then emits
// the flattened/packed host layouts directly (ops/bvh_flat.py,
// ops/pack.py pack_bvh): fixed-L leaf groups, children-packed inner rows,
// triangle group rows with precomputed v0/e1/e2/n.
//
// Exposed via a C ABI consumed with ctypes (native/builder.py); the NumPy
// path remains as fallback and as the parity oracle in tests.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int kLanes = 128;
constexpr int kTriStride = 12;

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// xorshift64* — deterministic per seed; stands in for the reference's
// seeded rand() (cpu/src/main.c:91-95). Sequence differs from both C rand
// and NumPy RandomState; only per-seed determinism is contractual.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  int randint(int n) { return static_cast<int>(next() % n); }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// ---------------------------------------------------------------------------
// BVH build (reference-tree semantics, ops/bvh.py parity)
// ---------------------------------------------------------------------------

struct BuildTree {
  // Reference-style node arrays (count > 0 => leaf; a = first perm index for
  // leaves, left child for inners; children adjacent — cpu/include/bvh.h:14-23).
  std::vector<Vec3> node_min, node_max;
  std::vector<int32_t> count, a;
  std::vector<int32_t> perm;
  std::vector<int64_t> leaf_sizes;
  int n_nodes = 0;
};

struct Builder {
  const float *tv;  // (T, 9)
  int64_t T;
  int heuristic, max_depth, leaf_threshold, sah_bins;
  bool true_sah;
  Rng rng;
  std::vector<Vec3> bb_min, bb_max, cent;
  BuildTree t;

  Builder(const float *tv_, int64_t T_, int h, int md, int lt, int sb,
          uint64_t seed, bool tsah = false)
      : tv(tv_), T(T_), heuristic(h), max_depth(md), leaf_threshold(lt),
        sah_bins(sb), true_sah(tsah), rng(seed) {}

  void computeBounds() {
    bb_min.resize(T);
    bb_max.resize(T);
    cent.resize(T);
    for (int64_t i = 0; i < T; ++i) {
      const float *p = tv + i * 9;
      Vec3 a{p[0], p[1], p[2]}, b{p[3], p[4], p[5]}, c{p[6], p[7], p[8]};
      bb_min[i] = vmin(a, vmin(b, c));
      bb_max[i] = vmax(a, vmax(b, c));
      cent[i] = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                 (a.z + b.z + c.z) / 3.0f};
    }
  }

  static float axisOf(const Vec3 &v, int ax) {
    return ax == 0 ? v.x : (ax == 1 ? v.y : v.z);
  }

  // Reference tie-break order (cpu/src/bvh.c:218-222 / ops/bvh.py
  // _largest_axis): axis 0 unless y strictly larger; z only if strictly
  // larger than both.
  static int largestAxis(const Vec3 &size) {
    int ax = 0;
    if (size.y > size.x) ax = 1;
    float m = ax == 0 ? size.x : size.y;
    if (size.z > size.x && size.z > size.y) ax = 2;
    (void)m;
    return ax;
  }

  void grownBounds(const int32_t *idx, int n, Vec3 *lo, Vec3 *hi) const {
    Vec3 l{1e30f, 1e30f, 1e30f}, h{-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; ++i) {
      l = vmin(l, bb_min[idx[i]]);
      h = vmax(h, bb_max[idx[i]]);
    }
    *lo = l;
    *hi = h;
  }

  // Reference 'area' = squared diagonal (cpu/src/bvh.c:43-46), or real
  // surface area when true_sah (ops/bvh.py _area parity).
  double area(const Vec3 &lo, const Vec3 &hi) const {
    double dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    if (true_sah) return 2.0 * (dx * dy + dy * dz + dz * dx);
    return dx * dx + dy * dy + dz * dz;
  }

  void build() {
    computeBounds();
    int64_t cap = 2 * T;
    t.node_min.assign(cap, {1e10f, 1e10f, 1e10f});
    t.node_max.assign(cap, {-1e10f, -1e10f, -1e10f});
    t.count.assign(cap, 0);
    t.a.assign(cap, 0);
    t.perm.resize(T);
    std::iota(t.perm.begin(), t.perm.end(), 0);

    Vec3 lo, hi;
    grownBounds(t.perm.data(), (int)T, &lo, &hi);
    t.node_min[0] = lo;
    t.node_max[0] = hi;
    t.count[0] = (int32_t)T;
    t.a[0] = 0;
    t.n_nodes = 1;

    // Iterative DFS matching the recursive order (left before right).
    std::vector<std::pair<int, int>> stack;
    stack.push_back({0, 0});
    std::vector<int32_t> scratch;
    std::vector<int> order;
    while (!stack.empty()) {
      auto [node, depth] = stack.back();
      stack.pop_back();
      int first = t.a[node], n = t.count[node];

      if (t.n_nodes >= cap || depth == max_depth || n <= leaf_threshold) {
        t.leaf_sizes.push_back(n);
        continue;
      }
      int32_t *idx = t.perm.data() + first;

      int split_axis = 0;
      float split_pos = 0.0f;
      bool median_split = false, make_leaf = false;
      int median_half = n / 2;
      // left-mask for the median path (stable order semantics).
      std::vector<char> left_mask;

      Vec3 center{(t.node_min[node].x + t.node_max[node].x) * 0.5f,
                  (t.node_min[node].y + t.node_max[node].y) * 0.5f,
                  (t.node_min[node].z + t.node_max[node].z) * 0.5f};
      Vec3 size{t.node_max[node].x - t.node_min[node].x,
                t.node_max[node].y - t.node_min[node].y,
                t.node_max[node].z - t.node_min[node].z};

      auto stableOrder = [&](int ax) {
        order.resize(n);
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(), [&](int i, int j) {
          return axisOf(cent[idx[i]], ax) < axisOf(cent[idx[j]], ax);
        });
      };

      switch (heuristic) {
        case 0:
          split_axis = 0;
          split_pos = center.x;
          break;
        case 1:
          split_axis = largestAxis(size);
          split_pos = axisOf(center, split_axis);
          break;
        case 2:
          split_axis = rng.randint(3);
          split_pos = axisOf(center, split_axis);
          break;
        case 3: {
          bool ok = false;
          for (int tries = 0; tries < 64; ++tries) {
            split_axis = rng.randint(3);
            split_pos = axisOf(center, split_axis) +
                        (float)((rng.uniform() - 0.5) * axisOf(size, split_axis));
            int na = 0;
            for (int i = 0; i < n; ++i)
              na += axisOf(cent[idx[i]], split_axis) < split_pos;
            if (na > 0 && na < n) {
              ok = true;
              break;
            }
          }
          if (!ok) make_leaf = true;
          break;
        }
        case 4:
          split_axis = largestAxis(size);
          median_split = true;
          break;
        case 5: {
          double best = 1e300;
          for (int ax = 0; ax < 3; ++ax) {
            stableOrder(ax);
            scratch.resize(n);
            for (int i = 0; i < n; ++i) scratch[i] = idx[order[i]];
            Vec3 llo, lhi, rlo, rhi;
            grownBounds(scratch.data(), median_half, &llo, &lhi);
            grownBounds(scratch.data() + median_half, n - median_half, &rlo,
                        &rhi);
            double score = median_half * area(llo, lhi) +
                           (n - median_half) * area(rlo, rhi);
            if (score < best) {
              best = score;
              split_axis = ax;
            }
          }
          median_split = true;
          break;
        }
        case 6: {
          double best = 1e300;
          bool found = false;
          std::vector<Vec3> pre_min, pre_max, suf_min, suf_max;
          std::vector<float> sc;
          for (int ax = 0; ax < 3; ++ax) {
            stableOrder(ax);
            sc.resize(n);
            pre_min.resize(n);
            pre_max.resize(n);
            suf_min.resize(n);
            suf_max.resize(n);
            for (int i = 0; i < n; ++i) {
              int32_t ti = idx[order[i]];
              sc[i] = axisOf(cent[ti], ax);
              pre_min[i] = i ? vmin(pre_min[i - 1], bb_min[ti]) : bb_min[ti];
              pre_max[i] = i ? vmax(pre_max[i - 1], bb_max[ti]) : bb_max[ti];
            }
            for (int i = n - 1; i >= 0; --i) {
              int32_t ti = idx[order[i]];
              suf_min[i] =
                  i + 1 < n ? vmin(suf_min[i + 1], bb_min[ti]) : bb_min[ti];
              suf_max[i] =
                  i + 1 < n ? vmax(suf_max[i + 1], bb_max[ti]) : bb_max[ti];
            }
            auto consider = [&](float cand) {
              // k = first index with sc[k] >= cand (searchsorted 'left').
              int k = (int)(std::lower_bound(sc.begin(), sc.end(), cand) -
                            sc.begin());
              if (k <= 0 || k >= n) return;
              double score = (double)k * area(pre_min[k - 1], pre_max[k - 1]) +
                             (double)(n - k) * area(suf_min[k], suf_max[k]);
              if (score < best) {
                best = score;
                split_axis = ax;
                split_pos = cand;
                found = true;
              }
            };
            if (sah_bins == -1) {
              for (int i = 0; i < n; ++i) consider(axisOf(cent[idx[i]], ax));
            } else {
              float lo0 = axisOf(t.node_min[node], ax);
              float sz = axisOf(t.node_max[node], ax) - lo0;
              for (int b = 0; b < sah_bins; ++b)
                consider(lo0 + sz * ((float)b / sah_bins));
            }
          }
          if (!found) make_leaf = true;
          break;
        }
        default:
          make_leaf = true;
      }

      if (make_leaf) {
        t.leaf_sizes.push_back(n);
        continue;
      }

      int nl = 0;
      left_mask.assign(n, 0);
      if (median_split) {
        stableOrder(split_axis);
        for (int i = 0; i < median_half; ++i) left_mask[order[i]] = 1;
        nl = median_half;
      } else {
        for (int i = 0; i < n; ++i) {
          left_mask[i] = axisOf(cent[idx[i]], split_axis) < split_pos;
          nl += left_mask[i];
        }
      }
      if (t.n_nodes + 2 > cap) {
        t.leaf_sizes.push_back(n);
        continue;
      }

      int child = t.n_nodes;
      t.n_nodes += 2;
      // Stable partition of the shared perm range (cpu/src/bvh.c:244-259
      // semantics via ops/bvh.py's boolean-mask ordering).
      scratch.resize(n);
      int w = 0;
      for (int i = 0; i < n; ++i)
        if (left_mask[i]) scratch[w++] = idx[i];
      for (int i = 0; i < n; ++i)
        if (!left_mask[i]) scratch[w++] = idx[i];
      std::memcpy(idx, scratch.data(), n * sizeof(int32_t));

      Vec3 llo, lhi;
      if (nl > 0) {
        grownBounds(idx, nl, &llo, &lhi);
        t.node_min[child] = llo;
        t.node_max[child] = lhi;
      }
      t.count[child] = nl;
      t.a[child] = nl > 0 ? first : 0;
      if (n - nl > 0) {
        grownBounds(idx + nl, n - nl, &llo, &lhi);
        t.node_min[child + 1] = llo;
        t.node_max[child + 1] = lhi;
      }
      t.count[child + 1] = n - nl;
      t.a[child + 1] = (n - nl) > 0 ? first + nl : 0;

      t.count[node] = 0;
      t.a[node] = child;
      stack.push_back({child + 1, depth + 1});
      stack.push_back({child, depth + 1});
    }
  }
};

// ---------------------------------------------------------------------------
// Flatten (ops/bvh_flat.py parity) + pack (ops/pallas_trace.py parity)
// ---------------------------------------------------------------------------

struct Flattened {
  std::vector<Vec3> fmin, fmax;
  std::vector<int32_t> count, a;
  std::vector<int32_t> slot_map;
  int leaf_size = 8;
  int depth = 0;
};

struct Flattener {
  const BuildTree &t;
  const std::vector<Vec3> &tri_min, &tri_max;
  int L;
  Flattened f;

  Flattener(const BuildTree &t_, const std::vector<Vec3> &tmin,
            const std::vector<Vec3> &tmax, int L_)
      : t(t_), tri_min(tmin), tri_max(tmax), L(L_) {
    f.leaf_size = L;
  }

  bool live(int i) const { return t.count[i] > 0 || t.a[i] != 0; }

  int collapse(int i) const {
    while (t.count[i] == 0) {
      int c = t.a[i];
      bool ll = live(c), rl = live(c + 1);
      if (ll && rl) break;
      if (!(ll || rl)) break;
      i = ll ? c : c + 1;
    }
    return i;
  }

  int alloc() {
    f.fmin.push_back({});
    f.fmax.push_back({});
    f.count.push_back(0);
    f.a.push_back(0);
    return (int)f.count.size() - 1;
  }

  void triBounds(const int32_t *tris, int n, Vec3 *lo, Vec3 *hi) const {
    Vec3 l{1e30f, 1e30f, 1e30f}, h{-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; ++i) {
      l = vmin(l, tri_min[tris[i]]);
      h = vmax(h, tri_max[tris[i]]);
    }
    *lo = l;
    *hi = h;
  }

  void emitGroup(int slot, const int32_t *tris, int n, int depth) {
    int base = (int)(f.slot_map.size());
    for (int i = 0; i < n; ++i) f.slot_map.push_back(tris[i]);
    for (int i = n; i < L; ++i) f.slot_map.push_back(-1);
    triBounds(tris, n, &f.fmin[slot], &f.fmax[slot]);
    f.count[slot] = n;
    f.a[slot] = base;
    f.depth = std::max(f.depth, depth);
  }

  void emitTris(int slot, const int32_t *tris, int n, int depth) {
    if (n <= L) {
      emitGroup(slot, tris, n, depth);
      return;
    }
    int k = (n + L - 1) / L;
    int cut = (k / 2) * L;
    int pair = alloc();
    alloc();
    triBounds(tris, n, &f.fmin[slot], &f.fmax[slot]);
    f.count[slot] = 0;
    f.a[slot] = pair;
    emitTris(pair, tris, cut, depth + 1);
    emitTris(pair + 1, tris + cut, n - cut, depth + 1);
  }

  void emit(int i, int slot, int depth) {
    i = collapse(i);
    int cnt = t.count[i];
    if (cnt > 0) {
      emitTris(slot, t.perm.data() + t.a[i], cnt, depth);
      return;
    }
    int c = t.a[i];
    int pair = alloc();
    alloc();
    f.fmin[slot] = t.node_min[i];
    f.fmax[slot] = t.node_max[i];
    f.count[slot] = 0;
    f.a[slot] = pair;
    f.depth = std::max(f.depth, depth);
    emit(c, pair, depth + 1);
    emit(c + 1, pair + 1, depth + 1);
  }

  void run() {
    int root = alloc();
    emit(0, root, 0);
  }
};

struct Packed {
  std::vector<float> cbox;    // (Ni, 16)
  std::vector<int32_t> cmeta; // (Ni, 8)
  std::vector<float> tri;     // (G, 128)
  int64_t n_inner = 0, n_groups = 0;
};

static void pack(const Flattened &f, const float *tv, Packed *p) {
  int L = f.leaf_size;
  int64_t N = (int64_t)f.count.size();
  std::vector<int64_t> remap(N, -1);
  int64_t ni = 0;
  for (int64_t i = 0; i < N; ++i)
    if (f.count[i] == 0) remap[i] = ni++;

  if (ni == 0) {
    // Root is a leaf: synthetic inner with BOTH children pointing at it.
    // (An inverted AABB is not a never-hit sentinel under the ordered slab
    // test, so the second child duplicates the leaf — idempotent.)
    p->n_inner = 1;
    p->cbox.assign(16, 0.0f);
    p->cbox[0] = p->cbox[6] = f.fmin[0].x;
    p->cbox[1] = p->cbox[7] = f.fmin[0].y;
    p->cbox[2] = p->cbox[8] = f.fmin[0].z;
    p->cbox[3] = p->cbox[9] = f.fmax[0].x;
    p->cbox[4] = p->cbox[10] = f.fmax[0].y;
    p->cbox[5] = p->cbox[11] = f.fmax[0].z;
    p->cmeta.assign(8, 0);
    p->cmeta[0] = p->cmeta[1] = -(f.a[0] / L) - 1;
  } else {
    p->n_inner = ni;
    p->cbox.assign(ni * 16, 0.0f);
    p->cmeta.assign(ni * 8, 0);
    for (int64_t i = 0; i < N; ++i) {
      if (f.count[i] != 0) continue;
      int64_t r = remap[i];
      int c = f.a[i];
      float *row = p->cbox.data() + r * 16;
      row[0] = f.fmin[c].x;  row[1] = f.fmin[c].y;  row[2] = f.fmin[c].z;
      row[3] = f.fmax[c].x;  row[4] = f.fmax[c].y;  row[5] = f.fmax[c].z;
      row[6] = f.fmin[c + 1].x; row[7] = f.fmin[c + 1].y; row[8] = f.fmin[c + 1].z;
      row[9] = f.fmax[c + 1].x; row[10] = f.fmax[c + 1].y; row[11] = f.fmax[c + 1].z;
      int32_t *m = p->cmeta.data() + r * 8;
      for (int k = 0; k < 2; ++k) {
        int ch = c + k;
        m[k] = f.count[ch] > 0 ? -(f.a[ch] / L) - 1 : (int32_t)remap[ch];
      }
    }
  }

  int64_t S = (int64_t)f.slot_map.size();
  int64_t G = S / L;
  p->n_groups = G;
  p->tri.assign(G * kLanes, 0.0f);
  for (int64_t s = 0; s < S; ++s) {
    int32_t ti = f.slot_map[s];
    if (ti < 0) continue;
    const float *src = tv + (int64_t)ti * 9;
    float v0[3] = {src[0], src[1], src[2]};
    float e1[3] = {src[3] - v0[0], src[4] - v0[1], src[5] - v0[2]};
    float e2[3] = {src[6] - v0[0], src[7] - v0[1], src[8] - v0[2]};
    float nx = e1[1] * e2[2] - e1[2] * e2[1];
    float ny = e1[2] * e2[0] - e1[0] * e2[2];
    float nz = e1[0] * e2[1] - e1[1] * e2[0];
    float *dst = p->tri.data() + (s / L) * kLanes + (s % L) * kTriStride;
    dst[0] = v0[0]; dst[1] = v0[1]; dst[2] = v0[2];
    dst[3] = e1[0]; dst[4] = e1[1]; dst[5] = e1[2];
    dst[6] = e2[0]; dst[7] = e2[1]; dst[8] = e2[2];
    dst[9] = nx;    dst[10] = ny;   dst[11] = nz;
  }
}

struct Handle {
  BuildTree tree;
  Flattened flat;
  Packed packed;
};

// ---------------------------------------------------------------------------
// Scene loading (cpu/src/triangle.c + light.c semantics)
// ---------------------------------------------------------------------------

struct SceneData {
  std::vector<float> verts;   // (V, 3)
  std::vector<int32_t> faces; // (F, 3)
  std::vector<int32_t> mat_idx;
  std::vector<float> kd, ks, kr; // (M, 3) each, slot 0 = implicit zeros
  std::vector<float> lights;     // (Lg, 6)
};

static bool startsWith(const std::string &s, const char *p) {
  return s.rfind(p, 0) == 0;
}

static void parse3(const std::string &line, float out[3]) {
  std::istringstream ss(line);
  std::string tag;
  ss >> tag;
  out[0] = out[1] = out[2] = 0.0f;
  ss >> out[0] >> out[1] >> out[2];
}

static SceneData *loadScene(const char *dir) {
  auto path = [&](const char *f) { return std::string(dir) + "/" + f; };
  std::ifstream obj(path("triangles.obj"));
  if (!obj.good()) return nullptr;

  auto sd = new SceneData();

  // MTL: newmtl + Kd/Ks/Kr within the next 5 lines (cpu/src/triangle.c:54-72);
  // duplicates keep the first entry; <= 128 materials.
  std::vector<std::string> names;
  {
    std::ifstream mtl(path("triangles.mtl"));
    std::vector<std::string> lines;
    std::string line;
    while (mtl.good() && std::getline(mtl, line)) lines.push_back(line);
    sd->kd.assign(3, 0.0f);  // slot 0: implicit "no material yet"
    sd->ks.assign(3, 0.0f);
    sd->kr.assign(3, 0.0f);
    for (size_t i = 0; i < lines.size(); ++i) {
      if (!startsWith(lines[i], "newmtl") || names.size() >= 128) continue;
      std::istringstream ss(lines[i]);
      std::string tag, name;
      ss >> tag >> name;
      float ckd[3] = {0, 0, 0}, cks[3] = {0, 0, 0}, ckr[3] = {0, 0, 0};
      for (size_t j = i + 1; j < std::min(i + 6, lines.size()); ++j) {
        if (startsWith(lines[j], "Kd")) parse3(lines[j], ckd);
        else if (startsWith(lines[j], "Ks")) parse3(lines[j], cks);
        else if (startsWith(lines[j], "Kr")) parse3(lines[j], ckr);
      }
      names.push_back(name);
      for (int k = 0; k < 3; ++k) {
        sd->kd.push_back(ckd[k]);
        sd->ks.push_back(cks[k]);
        sd->kr.push_back(ckr[k]);
      }
    }
  }

  auto lookup = [&](const std::string &name) -> int {
    for (size_t i = 0; i < names.size(); ++i)
      if (names[i] == name) return (int)i + 1;  // +1: slot 0 is implicit
    return -1;
  };

  int current = 0;
  std::string line;
  while (std::getline(obj, line)) {
    if (startsWith(line, "v ")) {
      float v[3];
      parse3(line, v);
      sd->verts.insert(sd->verts.end(), v, v + 3);
    } else if (startsWith(line, "usemtl")) {
      std::istringstream ss(line);
      std::string tag, name;
      ss >> tag >> name;
      int m = lookup(name);
      if (m >= 0) current = m;  // unknown name keeps current material
    } else if (startsWith(line, "f")) {
      std::istringstream ss(line);
      std::string tag, tok;
      ss >> tag;
      int32_t idx[3];
      int k = 0;
      while (k < 3 && ss >> tok) {
        idx[k++] = (int32_t)std::strtol(tok.c_str(), nullptr, 10) - 1;
      }
      if (k == 3) {
        sd->faces.insert(sd->faces.end(), idx, idx + 3);
        sd->mat_idx.push_back(current);
      }
    }
  }

  std::ifstream lf(path("lights.obj"));
  while (lf.good() && std::getline(lf, line)) {
    std::istringstream ss(line);
    float v[6];
    int k = 0;
    while (k < 6 && (ss >> v[k])) ++k;
    if (k == 6) sd->lights.insert(sd->lights.end(), v, v + 6);
  }
  return sd;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void *rt_bvh_build(const float *tv, long long T, int heuristic, int max_depth,
                   int leaf_threshold, int sah_bins, unsigned long long seed,
                   int leaf_size, int true_sah) {
  auto *h = new Handle();
  Builder b(tv, T, heuristic, max_depth, leaf_threshold, sah_bins, seed,
            true_sah != 0);
  b.build();
  h->tree = std::move(b.t);
  Flattener fl(h->tree, b.bb_min, b.bb_max, leaf_size);
  fl.run();
  h->flat = std::move(fl.f);
  pack(h->flat, tv, &h->packed);
  return h;
}

long long rt_bvh_n_flat_nodes(void *hp) {
  return (long long)static_cast<Handle *>(hp)->flat.count.size();
}
long long rt_bvh_n_slots(void *hp) {
  return (long long)static_cast<Handle *>(hp)->flat.slot_map.size();
}
long long rt_bvh_n_inner(void *hp) {
  return static_cast<Handle *>(hp)->packed.n_inner;
}
long long rt_bvh_n_groups(void *hp) {
  return static_cast<Handle *>(hp)->packed.n_groups;
}
int rt_bvh_depth(void *hp) { return static_cast<Handle *>(hp)->flat.depth; }

void rt_bvh_get_flat(void *hp, float *node_min, float *node_max,
                     int32_t *count, int32_t *a, int32_t *slot_map) {
  auto *h = static_cast<Handle *>(hp);
  int64_t N = (int64_t)h->flat.count.size();
  for (int64_t i = 0; i < N; ++i) {
    node_min[i * 3 + 0] = h->flat.fmin[i].x;
    node_min[i * 3 + 1] = h->flat.fmin[i].y;
    node_min[i * 3 + 2] = h->flat.fmin[i].z;
    node_max[i * 3 + 0] = h->flat.fmax[i].x;
    node_max[i * 3 + 1] = h->flat.fmax[i].y;
    node_max[i * 3 + 2] = h->flat.fmax[i].z;
  }
  std::memcpy(count, h->flat.count.data(), N * sizeof(int32_t));
  std::memcpy(a, h->flat.a.data(), N * sizeof(int32_t));
  std::memcpy(slot_map, h->flat.slot_map.data(),
              h->flat.slot_map.size() * sizeof(int32_t));
}

void rt_bvh_get_packed(void *hp, float *cbox, int32_t *cmeta, float *tri) {
  auto *h = static_cast<Handle *>(hp);
  std::memcpy(cbox, h->packed.cbox.data(),
              h->packed.cbox.size() * sizeof(float));
  std::memcpy(cmeta, h->packed.cmeta.data(),
              h->packed.cmeta.size() * sizeof(int32_t));
  std::memcpy(tri, h->packed.tri.data(), h->packed.tri.size() * sizeof(float));
}

void rt_bvh_stats(void *hp, double *out) {
  auto *h = static_cast<Handle *>(hp);
  const auto &ls = h->tree.leaf_sizes;
  double mn = 1e300, mx = 0, sum = 0;
  for (auto v : ls) {
    mn = std::min(mn, (double)v);
    mx = std::max(mx, (double)v);
    sum += (double)v;
  }
  out[0] = ls.empty() ? 0 : mn;
  out[1] = mx;
  out[2] = ls.empty() ? 0 : sum / ls.size();
  out[3] = (double)ls.size();
  out[4] = (double)h->tree.n_nodes;
}

void rt_bvh_free(void *hp) { delete static_cast<Handle *>(hp); }

// --- scene loading ---

void *rt_scene_load(const char *dir) { return loadScene(dir); }
long long rt_scene_n_verts(void *sp) {
  return (long long)static_cast<SceneData *>(sp)->verts.size() / 3;
}
long long rt_scene_n_faces(void *sp) {
  return (long long)static_cast<SceneData *>(sp)->faces.size() / 3;
}
long long rt_scene_n_mats(void *sp) {
  return (long long)static_cast<SceneData *>(sp)->kd.size() / 3;
}
long long rt_scene_n_lights(void *sp) {
  return (long long)static_cast<SceneData *>(sp)->lights.size() / 6;
}
void rt_scene_get(void *sp, float *verts, int32_t *faces, int32_t *mat_idx,
                  float *kd, float *ks, float *kr, float *lights) {
  auto *sd = static_cast<SceneData *>(sp);
  auto cp = [](auto &v, auto *dst) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  cp(sd->verts, verts);
  cp(sd->faces, faces);
  cp(sd->mat_idx, mat_idx);
  cp(sd->kd, kd);
  cp(sd->ks, ks);
  cp(sd->kr, kr);
  cp(sd->lights, lights);
}
void rt_scene_free(void *sp) { delete static_cast<SceneData *>(sp); }

}  // extern "C"
