// Binned-SAH BVH2 builder with insertion-based optimization, emitting the
// threaded (skip-link) flat layout: a frozen copy of the port's
// loupiote_tpu_torch/csrc/bvh_builder.cpp, built by bvh.py with g++ for
// the reference's own tree. The reference builds the tree the program
// builds from the same triangles, so that its closest hits break ties
// between triangles at one t as the program's traversal does.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
  Vec3() : x(0), y(0), z(0) {}
  Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void grow(const AABB& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Node {
  Vec3 lo, hi;
  int32_t first;   // leaf: first tri; internal: left child (== self+1)
  int32_t count;   // 0 for internal
  int32_t miss;
  int32_t right;   // -1 for leaves
  int32_t axis;    // split axis for internal nodes (-1 for leaves)
};

struct Builder {
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;   // work permutation
  std::vector<Node> nodes;
  int leaf_max;

  // Recursive build over order[lo, hi); emits pre-order so left = me+1.
  int build(int lo, int hi) {
    int me = static_cast<int>(nodes.size());
    nodes.emplace_back();

    AABB bounds, cbounds;
    for (int i = lo; i < hi; ++i) {
      bounds.grow(tri_box[order[i]]);
      cbounds.grow(centroid[order[i]]);
    }
    Node& n0 = nodes[me];
    n0.lo = bounds.lo;
    n0.hi = bounds.hi;

    int count = hi - lo;
    if (count <= leaf_max) {
      nodes[me].first = lo;  // order is emitted in place: leaf ranges are
      nodes[me].count = count;  // contiguous in the final permutation
      nodes[me].right = -1;
      nodes[me].axis = -1;
      return me;
    }

    // Binned SAH over the centroid bounds.
    int best_axis = -1, best_bin = -1;
    float best_cost = FLT_MAX;
    Vec3 ext(cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
             cbounds.hi.z - cbounds.lo.z);
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] <= 1e-12f) continue;
      float scale = kBins / ext[axis];
      AABB bb[kBins];
      int cnt[kBins] = {0};
      for (int i = lo; i < hi; ++i) {
        int t = order[i];
        int b = std::min(kBins - 1, std::max(0, static_cast<int>(
            (centroid[t][axis] - cbounds.lo[axis]) * scale)));
        bb[b].grow(tri_box[t]);
        cnt[b]++;
      }
      AABB left_acc;
      float left_area[kBins];
      int left_cnt[kBins];
      int acc = 0;
      for (int b = 0; b < kBins; ++b) {
        left_acc.grow(bb[b]);
        acc += cnt[b];
        left_area[b] = left_acc.area();
        left_cnt[b] = acc;
      }
      AABB right_acc;
      for (int b = kBins - 1; b > 0; --b) {
        right_acc.grow(bb[b]);
        int cl = left_cnt[b - 1], cr = count - cl;
        if (cl == 0 || cr == 0) continue;
        float cost = 1.0f + left_area[b - 1] * cl + right_acc.area() * cr;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate: median split on the largest centroid extent.
      int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2)
                               : (ext.y > ext.z ? 1 : 2);
      mid = lo + count / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid,
                       order.begin() + hi, [&](int a, int b) {
                         return centroid[a][axis] < centroid[b][axis];
                       });
      nodes[me].axis = axis;
    } else {
      float scale = kBins / ext[best_axis];
      auto it = std::partition(
          order.begin() + lo, order.begin() + hi, [&](int t) {
            int b = std::min(kBins - 1, std::max(0, static_cast<int>(
                (centroid[t][best_axis] - cbounds.lo[best_axis]) * scale)));
            return b < best_bin;
          });
      mid = static_cast<int>(it - order.begin());
      if (mid == lo || mid == hi) mid = lo + count / 2;
      nodes[me].axis = best_axis;
    }

    nodes[me].count = 0;
    int left = build(lo, mid);
    (void)left;  // == me + 1 by construction
    int right = build(mid, hi);
    nodes[me].first = me + 1;
    nodes[me].right = right;
    return me;
  }

  void thread_links() {
    // Pre-order walk assigning miss links (END = nodes.size()).
    int end = static_cast<int>(nodes.size());
    std::vector<std::pair<int, int>> stack;
    stack.push_back({0, end});
    while (!stack.empty()) {
      auto [n, m] = stack.back();
      stack.pop_back();
      nodes[n].miss = m;
      if (nodes[n].count == 0) {
        stack.push_back({n + 1, nodes[n].right});
        stack.push_back({nodes[n].right, m});
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Insertion-based BVH optimizer (Bittner et al. 2013, "Fast Insertion-Based
// Optimization of Bounding Volume Hierarchies"): repeatedly remove the
// highest-inefficiency internal nodes and re-insert their two child subtrees
// at the globally SAH-optimal positions found by branch-and-bound. Pure
// tree-QUALITY work on the CPU — the traversal kernels are unchanged, so the
// win is fewer union steps per sub-packet (the validated step-count lever).
// The reference reaches the same end through tinybvh's optimized builders
// (Cargo.lock:3391-3399).

struct OptTree {
  // Mutable binary tree with parent links. Leaves keep the builder's
  // (first,count) range into the order permutation.
  std::vector<AABB> box;
  std::vector<int> left, right, parent;  // -1 where absent
  std::vector<int32_t> first, count;
  int root = 0;

  bool is_leaf(int n) const { return left[n] < 0; }

  void refit_up(int n) {
    while (n >= 0) {
      AABB b = box[left[n]];
      b.grow(box[right[n]]);
      box[n].lo = b.lo;
      box[n].hi = b.hi;
      n = parent[n];
    }
  }

  // Branch-and-bound search (priority queue on induced cost) for the
  // sibling that minimizes total SAH area increase of inserting a subtree
  // with box `nb`. Returns the chosen sibling node.
  int find_sibling(const AABB& nb) const {
    float nb_area = nb.area();
    using QE = std::pair<float, int>;  // (induced cost, node)
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
    q.push({0.f, root});
    float best_cost = FLT_MAX;
    int best = root;
    while (!q.empty()) {
      auto [induced, n] = q.top();
      q.pop();
      if (induced + nb_area >= best_cost) break;  // queue is sorted: done
      AABB u = box[n];
      u.grow(nb);
      float direct = u.area();
      float total = induced + direct;
      if (total < best_cost) {
        best_cost = total;
        best = n;
      }
      if (!is_leaf(n)) {
        float child_induced = induced + (direct - box[n].area());
        if (child_induced + nb_area < best_cost) {
          q.push({child_induced, left[n]});
          q.push({child_induced, right[n]});
        }
      }
    }
    return best;
  }

  // Insert subtree `sub` next to `sib`, recycling `spare` as the new
  // internal parent; refits ancestors.
  void insert(int sub, int sib, int spare) {
    int gp = parent[sib];
    left[spare] = sib;
    right[spare] = sub;
    parent[sib] = spare;
    parent[sub] = spare;
    parent[spare] = gp;
    first[spare] = 0;
    count[spare] = 0;
    if (gp < 0) {
      root = spare;
    } else if (left[gp] == sib) {
      left[gp] = spare;
    } else {
      right[gp] = spare;
    }
    AABB b = box[sib];
    b.grow(box[sub]);
    box[spare].lo = b.lo;
    box[spare].hi = b.hi;
    refit_up(gp);
  }

  float sah_cost() const {
    double c = 0;
    float ra = std::max(box[root].area(), 1e-30f);
    for (size_t i = 0; i < box.size(); ++i) {
      if (parent[i] < 0 && static_cast<int>(i) != root) continue;  // freed
      c += box[i].area() / ra * (is_leaf(i) ? count[i] : 1.0);
    }
    return static_cast<float>(c);
  }

  void optimize(int rounds, float batch_frac) {
    int n_nodes = static_cast<int>(box.size());
    if (n_nodes < 16) return;
    std::vector<std::pair<float, int>> cands;
    float prev_cost = sah_cost();
    for (int round = 0; round < rounds; ++round) {
      // Rank internal nodes by Bittner's combined inefficiency measure:
      // m = a(n) * [a(n)/min(a(l),a(r))] * [2 a(n)/(a(l)+a(r))].
      cands.clear();
      for (int i = 0; i < n_nodes; ++i) {
        if (is_leaf(i) || i == root || parent[i] < 0) continue;
        float a = box[i].area();
        float al = box[left[i]].area(), ar = box[right[i]].area();
        float m = a * (a / std::max(std::min(al, ar), 1e-30f)) *
                  (2.f * a / std::max(al + ar, 1e-30f));
        cands.push_back({m, i});
      }
      int batch = std::max(1, static_cast<int>(cands.size() * batch_frac));
      if (batch < static_cast<int>(cands.size())) {
        std::nth_element(cands.begin(), cands.begin() + batch, cands.end(),
                         [](const auto& x, const auto& y) {
                           return x.first > y.first;
                         });
        cands.resize(batch);
      }
      std::sort(cands.begin(), cands.end(),
                [](const auto& x, const auto& y) { return x.first > y.first; });
      for (auto& [m, n] : cands) {
        // Node set mutates within the batch: re-validate.
        if (n == root || parent[n] < 0 || is_leaf(n)) continue;
        int p = parent[n];
        if (p == root ? false : parent[p] < 0) continue;
        // Remove n: its children become free subtrees; sibling splices
        // into p's place; n and p become spare internal nodes.
        int l = left[n], r = right[n];
        int sib = (left[p] == n) ? right[p] : left[p];
        int gp = parent[p];
        parent[sib] = gp;
        if (gp < 0) {
          root = sib;
        } else if (left[gp] == p) {
          left[gp] = sib;
        } else {
          right[gp] = sib;
        }
        parent[n] = -1;
        parent[p] = -1;
        refit_up(gp);
        // Reinsert the larger subtree first (better search targets).
        if (box[l].area() < box[r].area()) std::swap(l, r);
        parent[l] = -1;
        parent[r] = -1;
        insert(l, find_sibling(box[l]), n);
        insert(r, find_sibling(box[r]), p);
      }
      float cost = sah_cost();
      if (cost > prev_cost * 0.9999f) break;  // converged
      prev_cost = cost;
    }
  }
};

// Re-emit an OptTree as the threaded pre-order flat layout, composing the
// leaf triangle ranges into a fresh contiguous permutation.
void emit_preorder(const OptTree& t, const std::vector<int32_t>& old_order,
                   Builder* b) {
  b->nodes.clear();
  std::vector<int32_t> new_order;
  new_order.reserve(old_order.size());
  // DFS emitting (tree node, patch slot) pairs; pre-order => left = me+1.
  std::vector<std::pair<int, int>> stack;  // (opt node, parent to patch)
  stack.push_back({t.root, -1});
  while (!stack.empty()) {
    auto [n, patch] = stack.back();
    stack.pop_back();
    int me = static_cast<int>(b->nodes.size());
    b->nodes.emplace_back();
    Node& nd = b->nodes[me];
    nd.lo = t.box[n].lo;
    nd.hi = t.box[n].hi;
    if (patch >= 0) b->nodes[patch].right = me;
    if (t.is_leaf(n)) {
      nd.first = static_cast<int32_t>(new_order.size());
      nd.count = t.count[n];
      nd.right = -1;
      nd.axis = -1;
      for (int k = 0; k < t.count[n]; ++k)
        new_order.push_back(old_order[t.first[n] + k]);
    } else {
      nd.first = me + 1;
      nd.count = 0;
      // Descent-order hint: axis of largest child-center separation.
      Vec3 cl((t.box[t.left[n]].lo.x + t.box[t.left[n]].hi.x) * 0.5f,
              (t.box[t.left[n]].lo.y + t.box[t.left[n]].hi.y) * 0.5f,
              (t.box[t.left[n]].lo.z + t.box[t.left[n]].hi.z) * 0.5f);
      Vec3 cr((t.box[t.right[n]].lo.x + t.box[t.right[n]].hi.x) * 0.5f,
              (t.box[t.right[n]].lo.y + t.box[t.right[n]].hi.y) * 0.5f,
              (t.box[t.right[n]].lo.z + t.box[t.right[n]].hi.z) * 0.5f);
      float dx = std::fabs(cl.x - cr.x), dy = std::fabs(cl.y - cr.y),
            dz = std::fabs(cl.z - cr.z);
      nd.axis = dx > dy ? (dx > dz ? 0 : 2) : (dy > dz ? 1 : 2);
      stack.push_back({t.right[n], me});
      stack.push_back({t.left[n], -1});
    }
  }
  b->order = std::move(new_order);
  b->thread_links();
}

}  // namespace

extern "C" {

// Returns an opaque handle; query sizes then copy out and free.
void* bvh_build(const float* v0, const float* v1, const float* v2,
                int32_t tri_count, int32_t leaf_max) {
  auto* b = new Builder();
  b->leaf_max = leaf_max;
  b->tri_box.resize(tri_count);
  b->centroid.resize(tri_count);
  b->order.resize(tri_count);
  for (int i = 0; i < tri_count; ++i) {
    Vec3 a(v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]);
    Vec3 c(v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]);
    Vec3 d(v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]);
    AABB box;
    box.grow(a);
    box.grow(c);
    box.grow(d);
    b->tri_box[i] = box;
    b->centroid[i] = Vec3((box.lo.x + box.hi.x) * 0.5f,
                          (box.lo.y + box.hi.y) * 0.5f,
                          (box.lo.z + box.hi.z) * 0.5f);
    b->order[i] = i;
  }
  b->nodes.reserve(2 * tri_count);
  b->build(0, tri_count);
  b->thread_links();
  return b;
}

// Build + insertion-based optimize (Bittner) + re-emit. `opt_rounds` caps
// the optimizer's batch rounds (0 = plain build); `batch_pct` is the
// percentage of internal nodes re-inserted per round (typ. 1-5).
void* bvh_build_opt(const float* v0, const float* v1, const float* v2,
                    int32_t tri_count, int32_t leaf_max, int32_t opt_rounds,
                    float batch_pct) {
  auto* b = static_cast<Builder*>(bvh_build(v0, v1, v2, tri_count, leaf_max));
  if (opt_rounds <= 0 || b->nodes.size() < 16) return b;
  // Lift the pre-order tree into parent-linked form.
  OptTree t;
  int n = static_cast<int>(b->nodes.size());
  t.box.resize(n);
  t.left.assign(n, -1);
  t.right.assign(n, -1);
  t.parent.assign(n, -1);
  t.first.resize(n);
  t.count.resize(n);
  for (int i = 0; i < n; ++i) {
    const Node& nd = b->nodes[i];
    t.box[i].lo = nd.lo;
    t.box[i].hi = nd.hi;
    t.first[i] = nd.first;
    t.count[i] = nd.count;
    if (nd.count == 0) {
      t.left[i] = i + 1;
      t.right[i] = nd.right;
      t.parent[i + 1] = i;
      t.parent[nd.right] = i;
    }
  }
  std::vector<int32_t> old_order = b->order;
  t.optimize(opt_rounds, batch_pct / 100.f);
  emit_preorder(t, old_order, b);
  return b;
}

// Relative SAH cost: sum over nodes of area/root_area, leaves weighted by
// triangle count — the standard tree-quality scalar for A/Bs.
float bvh_sah_cost(void* handle) {
  auto* b = static_cast<Builder*>(handle);
  AABB rootb;
  rootb.lo = b->nodes[0].lo;
  rootb.hi = b->nodes[0].hi;
  float ra = std::max(rootb.area(), 1e-30f);
  double c = 0;
  for (const Node& nd : b->nodes) {
    AABB bb;
    bb.lo = nd.lo;
    bb.hi = nd.hi;
    c += bb.area() / ra * (nd.count > 0 ? nd.count : 1.0);
  }
  return static_cast<float>(c);
}

int32_t bvh_num_nodes(void* handle) {
  return static_cast<int32_t>(static_cast<Builder*>(handle)->nodes.size());
}

// Copies flat arrays out. Caller allocates:
//   node_min/node_max: (N,3) f32; first/count/miss/right/axis: (N,) i32;
//   tri_order: (T,) i32.
void bvh_export(void* handle, float* node_min, float* node_max,
                int32_t* first, int32_t* count, int32_t* miss,
                int32_t* right, int32_t* axis, int32_t* tri_order) {
  auto* b = static_cast<Builder*>(handle);
  int n = static_cast<int>(b->nodes.size());
  for (int i = 0; i < n; ++i) {
    const Node& nd = b->nodes[i];
    node_min[3 * i] = nd.lo.x;
    node_min[3 * i + 1] = nd.lo.y;
    node_min[3 * i + 2] = nd.lo.z;
    node_max[3 * i] = nd.hi.x;
    node_max[3 * i + 1] = nd.hi.y;
    node_max[3 * i + 2] = nd.hi.z;
    first[i] = nd.first;
    count[i] = nd.count;
    miss[i] = nd.miss;
    right[i] = nd.right;
    axis[i] = nd.axis;
  }
  std::memcpy(tri_order, b->order.data(), b->order.size() * sizeof(int32_t));
}

void bvh_free(void* handle) { delete static_cast<Builder*>(handle); }

}  // extern "C"
