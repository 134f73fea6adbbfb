// The two-level traversal: the instance loop of one wave over a run of
// mesh groups whose BLASes all go to K2, in one launch.
//
// Replaces no TPU kernel: the reference runs its TLAS as XLA ops
// (loupiote_tpu/scene/instanced.py), and the port's plain torch loop
// (loupiote_tpu_torch/scene/instanced.py::_groups_plain) is this kernel's
// twin. It was added because that loop, issued op by op from the host,
// paced the two-level frame: about 32 device ops and two or three
// blocking copies a BLAS traversal, for little device work each.
//
// One thread a ray carries (best t, best triangle, best instance) through
// the run's groups in mesh-slot order, as the twin does:
//  - an unroll group (at most TLAS_UNROLL_MAX instances in the scene):
//    its instance visited with no cull;
//  - a visit group (a mesh with at most two instances): each instance
//    behind its world-box cull (<= best t);
//  - a candidate group: the group's union box, then each box's entry t
//    under the carried limit, the C nearest kept in registers in a stable
//    order (the lower local id first on equal t, as torch.sort(stable=True)
//    keeps them), C waves with a strict entry t < best t, then the exact
//    drain for this ray: the next box in (entry t, id) order while its
//    entry t beats best t. The twin drains every ray of the group once
//    any ray needs it; a ray that needs none would select only boxes at
//    or past its best t there, which change nothing.
// A visit takes the ray to object space by the instance's world-to-object
// row, rounded as the twin's torch ops round it, and walks the BLAS as K2
// does (bvh2_lane.cuh: near child by the direction sign, a 128-entry
// stack, the same slab and triangle arithmetic, K2's step bound), one
// lane at a time with no warp collective, since the lanes of a warp are at
// different instances. A hit renames its triangle by the instance's first
// triangle. Where the call's loop is this one launch, the kernel also
// writes the winners' u, v (the walk's own: the same triangle and
// object-space ray, so the same bits as the twin's recompute_uv after the
// loop); after a K1 run between launches they are recomputed in torch.
//
// Rounding the twin's way (it runs on the card as torch ops):
//  - the TLAS's box tests invert the direction with +1e-20 for any
//    component of magnitude at most 1e-20 (its _safe_inv), the BLAS walk
//    with K2's sign-keeping safe_inv;
//  - min / max return NaN where an operand is NaN (nan_minmax.cuh);
//  - a row of the transform is torch's sum over three products,
//    ((p0 + p2) + p1), whose zero accumulator turns a -0 into +0.
//
// What bounds it on an H100: the BLAS walks, as K2 (load latency and
// divergence, the tables in L2). A 640x360 wave is 230,400 threads, under
// half of the card's resident threads, so a launch lasts as long as its
// longest rays' walks, one after another.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bvh2_lane.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kCMax = 16;  // scene/instanced.py raises for a larger TLAS_C
constexpr unsigned kFull = 0xffffffffu;

// Group kinds (scene/instanced.py: UNROLL, VISIT, CANDIDATE).
constexpr int kUnroll = 0;
constexpr int kVisit = 1;

struct Args {
  const float* ro;
  const float* rd;
  const uint8_t* active;
  const float* t_in;
  const int32_t* tri_in;
  const int32_t* inst_in;
  float* t_out;
  int32_t* tri_out;
  int32_t* inst_out;
  float* u_out;  // null: u, v are recomputed after the loop
  float* v_out;
  const int4* groups;  // kind, first id, count, BLAS slot
  const int32_t* group_ids;
  const float* group_lo;  // (G, 3) union boxes
  const float* group_hi;
  const long long* blas_ptrs;  // (S, 2) node_rows, leaf_rows
  const int32_t* blas_steps;  // (S,) K2's step bound
  const float* w2o;  // (K, 16)
  const float* aabb_lo;  // (K, 3)
  const float* aabb_hi;
  const int32_t* tri_base;  // (K,)
  int32_t* capped;
  unsigned long long* walks;  // null unless a recording is on
  int n_rays, g0, g1, c_max;
};

struct World {
  float o[3], d[3], inv[3];
};

// The TLAS's inverse (instanced.py::_safe_inv): a tiny component turns +.
__device__ __forceinline__ float tlas_inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

// Entry and exit t of the box, the twin's order of min / max.
__device__ __forceinline__ void box_span(const World& w,
                                         const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         float* tn, float* tf) {
  float n = 0.0f, f = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ta = (__ldg(lo + a) - w.o[a]) * w.inv[a];
    const float tb = (__ldg(hi + a) - w.o[a]) * w.inv[a];
    const float l = min_nan(ta, tb), h = max_nan(ta, tb);
    n = a == 0 ? l : max_nan(n, l);
    f = a == 0 ? h : min_nan(f, h);
  }
  *tn = n;
  *tf = f;
}

// _ray_box_overlap: the ray meets [lo, hi] within (0, t1].
__device__ __forceinline__ bool box_overlap(const World& w, const float* lo,
                                            const float* hi, float t1) {
  float tn, tf;
  box_span(w, lo, hi, &tn, &tf);
  return tf >= max_nan(tn, kTMin) && tn <= t1;
}

// _chunk_tnear: the box's entry t where the ray overlaps it under lim,
// +inf where not.
__device__ __forceinline__ float box_tnear(const World& w, const float* lo,
                                           const float* hi, float lim) {
  float tn, tf;
  box_span(w, lo, hi, &tn, &tf);
  return (tf >= max_nan(tn, kTMin) && tn <= lim) ? tn : CUDART_INF_F;
}

// torch's sum over the last axis of three (a reduction split over two
// lanes from a zero accumulator): (p0 + p2) + p1, -0 read as +0.
__device__ __forceinline__ float sum3(float p0, float p1, float p2) {
  return ((p0 + p2) + p1) + 0.0f;
}

// instanced.py::_to_object for one ray and one row-major 4x4 matrix.
__device__ __forceinline__ Ray to_object(const float* __restrict__ m,
                                         const World& w) {
  float q[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) q[j] = __ldg(m + j);
  Ray r;
  r.ox = sum3(q[0] * w.o[0], q[1] * w.o[1], q[2] * w.o[2]) + q[3];
  r.oy = sum3(q[4] * w.o[0], q[5] * w.o[1], q[6] * w.o[2]) + q[7];
  r.oz = sum3(q[8] * w.o[0], q[9] * w.o[1], q[10] * w.o[2]) + q[11];
  r.dx = sum3(q[0] * w.d[0], q[1] * w.d[1], q[2] * w.d[2]);
  r.dy = sum3(q[4] * w.d[0], q[5] * w.d[1], q[6] * w.d[2]);
  r.dz = sum3(q[8] * w.d[0], q[9] * w.d[1], q[10] * w.d[2]);
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// K2's walk of one BLAS for one lane, bounded by *best: returns the hit's
// BLAS-local triangle (-1: none) and leaves its t, u, v in *best, *u,
// *v. An any-hit
// walk ends after the first leaf with a hit, whose closest hit it keeps.
// The order of nodes, the bound of each box test and the step count are
// K2's (bvh2_traverse.cu), whose lanes only wait for the warp at a leaf.
template <bool kAnyHit>
__device__ __forceinline__ int walk(const float* __restrict__ node_rows,
                    const float* __restrict__ leaf_rows, const Ray& r,
                    float* best, float* bu, float* bv, int max_steps,
                    int32_t* capped) {
  int tri = -1;
  int stack[kStackMax];
  int sp = 0, node = 0, steps = 0;
  while (node >= 0) {
    if (steps == max_steps) {  // the reference's silent step bound
      atomicAdd(capped, 1);
      break;
    }
    ++steps;
    int4 ints;  // count, miss, slot8, slot9
    const bool hit = slab(node_rows, node, r, *best, &ints);
    if (hit && ints.x == 0) {
      const float dax = ints.w == 0 ? r.dx : (ints.w == 1 ? r.dy : r.dz);
      const int left = node + 1, right = ints.z;
      const bool pos = dax >= 0.0f;
      stack[sp++] = pos ? right : left;
      node = pos ? left : right;
    } else {
      node = sp > 0 ? stack[--sp] : -1;
      if (hit && leaf_closest(leaf_rows + static_cast<size_t>(ints.z) * 128,
                              ints.x, ints.w, r, best, bu, bv, &tri) &&
          kAnyHit) {
        node = -1;
      }
    }
  }
  return tri;
}

// The kept entry at position s, read with compile-time indices, so the
// arrays stay in registers.
__device__ __forceinline__ void pick(const float (&top_t)[kCMax],
                                     const int (&top_j)[kCMax], int s,
                                     float* t, int* j) {
#pragma unroll
  for (int c = 0; c < kCMax; ++c) {
    if (c == s) {
      *t = top_t[c];
      *j = top_j[c];
    }
  }
}

// One ray's carry (t, tri, inst, u, v) through groups [g0, g1). Each
// group is a loop of steps with one visit site: an unroll or visit group's step is
// its next instance; a candidate group's first C steps are its waves, the
// later ones its drain. Returns the ray's BLAS walks.
template <bool kAnyHit>
__device__ __forceinline__ unsigned run_lane(const Args& a, const World& w,
                                             float& best_t, int& best_tri,
                                             int& best_inst, float& best_u,
                                             float& best_v) {
  unsigned walks = 0;
  for (int g = a.g0; g < a.g1; ++g) {
    if (kAnyHit && best_tri >= 0) break;  // blocked: nothing changes more
    const int4 grp = __ldg(a.groups + g);  // kind, first, count, slot
    const int* ids = a.group_ids + grp.y;
    const int count = grp.z, slot = grp.w;
    const bool cand = grp.x != kUnroll && grp.x != kVisit;
    float top_t[kCMax];
    int top_j[kCMax];
    int C = 0, n_ov = 0;
    if (cand) {
      // The union box, then the C nearest boxes under the carried limit.
      const float lim0 = best_t;
      if (!box_overlap(w, a.group_lo + 3 * g, a.group_hi + 3 * g, lim0))
        continue;
      C = a.c_max < count ? a.c_max : count;
#pragma unroll
      for (int c = 0; c < kCMax; ++c) {
        top_t[c] = CUDART_INF_F;
        top_j[c] = 0;
      }
      for (int j = 0; j < count; ++j) {
        const int k = __ldg(ids + j);
        const float tn =
            box_tnear(w, a.aabb_lo + 3 * k, a.aabb_hi + 3 * k, lim0);
        n_ov += isfinite(tn) ? 1 : 0;
        // Stable insertion: a slot past tn takes its left neighbour where
        // that is past tn too, else tn.
#pragma unroll
        for (int c = kCMax - 1; c >= 0; --c) {
          if (c < C && top_t[c] > tn) {
            if (c > 0 && top_t[c - 1] > tn) {
              top_t[c] = top_t[c - 1];
              top_j[c] = top_j[c - 1];
            } else {
              top_t[c] = tn;
              top_j[c] = j;
            }
          }
        }
      }
    }
    float last_t = 0.0f;  // the drain's last box, in (entry t, id) order
    int last = 0;
    for (int s = 0;; ++s) {
      if (kAnyHit && best_tri >= 0) break;
      int k;
      if (!cand) {
        if (s >= count) break;
        k = __ldg(ids + s);
        if (grp.x == kVisit &&
            !box_overlap(w, a.aabb_lo + 3 * k, a.aabb_hi + 3 * k, best_t))
          continue;
      } else if (s < C) {
        float sel;
        int j;
        pick(top_t, top_j, s, &sel, &j);
        if (!(isfinite(sel) && sel < best_t)) continue;
        k = __ldg(ids + j);
      } else {
        if (s == C) {
          // The twin's pending test, after the waves. A box at -inf (a
          // non-finite ray) stops its drain: its argmin returns that box.
          pick(top_t, top_j, C - 1, &last_t, &last);
          if (C >= count || !(n_ov > C && last_t < best_t) ||
              top_t[0] == -CUDART_INF_F)
            break;
        }
        float nt = CUDART_INF_F;
        int nj = -1;
        for (int j = 0; j < count; ++j) {
          const int kj = __ldg(ids + j);
          const float tn =
              box_tnear(w, a.aabb_lo + 3 * kj, a.aabb_hi + 3 * kj, best_t);
          const bool after = tn > last_t || (tn == last_t && j > last);
          if (isfinite(tn) && after && tn < nt) {
            nt = tn;
            nj = j;
          }
        }
        // None left, or none can beat best t: later boxes enter no sooner.
        if (nj < 0 || !(nt < best_t)) break;
        last_t = nt;
        last = nj;
        k = __ldg(ids + nj);
      }
      // Visit instance k: its BLAS walked in object space from best t.
      const Ray r = to_object(a.w2o + 16 * static_cast<size_t>(k), w);
      const float* nr = reinterpret_cast<const float*>(a.blas_ptrs[2 * slot]);
      const float* lr =
          reinterpret_cast<const float*>(a.blas_ptrs[2 * slot + 1]);
      float t = best_t, u = 0.0f, v = 0.0f;
      const int tri = walk<kAnyHit>(nr, lr, r, &t, &u, &v,
                                    __ldg(a.blas_steps + slot), a.capped);
      ++walks;
      if (tri >= 0) {
        if (!kAnyHit) best_t = t;
        best_tri = tri + __ldg(a.tri_base + k);
        best_inst = k;
        best_u = u;
        best_v = v;
      }
    }
  }
  return walks;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
    tlas_kernel(const __grid_constant__ Args a) {
  // No lane leaves early: the walk count is summed over the warp at the end.
  const int i = blockIdx.x * kThreads + threadIdx.x;
  unsigned walks = 0;
  if (i < a.n_rays) {
    float t = a.t_in[i], u = 0.0f, v = 0.0f;
    int tri = a.tri_in[i], inst = a.inst_in[i];
    if (a.active[i]) {
      World w;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w.o[c] = a.ro[3 * i + c];
        w.d[c] = a.rd[3 * i + c];
        w.inv[c] = tlas_inv(w.d[c]);
      }
      walks = run_lane<kAnyHit>(a, w, t, tri, inst, u, v);
    }
    a.t_out[i] = t;
    a.tri_out[i] = tri;
    a.inst_out[i] = inst;
    if (a.u_out != nullptr) {
      a.u_out[i] = u;
      a.v_out[i] = v;
    }
  }
  if (a.walks != nullptr) {
    const unsigned total = __reduce_add_sync(kFull, walks);
    if ((threadIdx.x & 31) == 0 && total > 0) {
      atomicAdd(a.walks, static_cast<unsigned long long>(total));
    }
  }
}

}  // namespace

// C entry point (ctypes). Pointers come from tensor.data_ptr(); the
// stream is torch.cuda.current_stream().cuda_stream. Runs groups [g0, g1)
// of the tables on every ray from the carry in; u_out / v_out (written
// only where given, from this launch's hits alone) and walks may be null.
// Returns
// cudaGetLastError() after the launch; allocates nothing, does not sync.
extern "C" int tlas_trace(
    const void* ro, const void* rd, const void* active, const void* t_in,
    const void* tri_in, const void* inst_in, void* t_out, void* tri_out,
    void* inst_out, void* u_out, void* v_out, const void* groups,
    const void* group_ids,
    const void* group_lo, const void* group_hi, const void* blas_ptrs,
    const void* blas_steps, const void* w2o, const void* aabb_lo,
    const void* aabb_hi, const void* tri_base, void* capped, void* walks,
    int n_rays, int g0, int g1, int c_max, int any_hit, void* stream) {
  if (n_rays <= 0 || g1 <= g0) return 0;
  if (c_max < 1 || c_max > kCMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.ro = static_cast<const float*>(ro);
  a.rd = static_cast<const float*>(rd);
  a.active = static_cast<const uint8_t*>(active);
  a.t_in = static_cast<const float*>(t_in);
  a.tri_in = static_cast<const int32_t*>(tri_in);
  a.inst_in = static_cast<const int32_t*>(inst_in);
  a.t_out = static_cast<float*>(t_out);
  a.tri_out = static_cast<int32_t*>(tri_out);
  a.inst_out = static_cast<int32_t*>(inst_out);
  a.u_out = static_cast<float*>(u_out);
  a.v_out = static_cast<float*>(v_out);
  a.groups = static_cast<const int4*>(groups);
  a.group_ids = static_cast<const int32_t*>(group_ids);
  a.group_lo = static_cast<const float*>(group_lo);
  a.group_hi = static_cast<const float*>(group_hi);
  a.blas_ptrs = static_cast<const long long*>(blas_ptrs);
  a.blas_steps = static_cast<const int32_t*>(blas_steps);
  a.w2o = static_cast<const float*>(w2o);
  a.aabb_lo = static_cast<const float*>(aabb_lo);
  a.aabb_hi = static_cast<const float*>(aabb_hi);
  a.tri_base = static_cast<const int32_t*>(tri_base);
  a.capped = static_cast<int32_t*>(capped);
  a.walks = static_cast<unsigned long long*>(walks);
  a.n_rays = n_rays;
  a.g0 = g0;
  a.g1 = g1;
  a.c_max = c_max;
  const dim3 block(kThreads);
  const dim3 grid((n_rays + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    tlas_kernel<true><<<grid, block, 0, s>>>(a);
  } else {
    tlas_kernel<false><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
