// K2's per-lane pieces, shared by K2 / K3 (bvh2_traverse.cu) and the
// two-level traversal (tlas_traverse.cu), which walks each BVH2 BLAS with
// them one lane at a time: the ray record and its sign-keeping inverse,
// the slab test of a node row, Moller-Trumbore in the reference's order
// of products, a leaf row's triangles read as 16-byte words, and the
// closest-hit and blocking folds over a leaf row. One definition, so a
// BLAS walk inside the two-level kernel rounds as K2 does.
#pragma once

#include <cuda_runtime.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kStackMax = 128;  // ops/bvh2.py raises for a deeper scene
constexpr int kLeafCap = 14;
constexpr float kTMin = 1e-4f;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* ro, const float* rd,
                                        int i) {
  Ray r;
  r.ox = ro[3 * i];
  r.oy = ro[3 * i + 1];
  r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i];
  r.dy = rd[3 * i + 1];
  r.dz = rd[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// Slab test of the node's box, the reference's order of products and
// min/max. Fills the node's four int columns.
__device__ __forceinline__ bool slab(const float* __restrict__ node_rows,
                                     int node, const Ray& r, float bound,
                                     int4* ints) {
  const float4* row = reinterpret_cast<const float4*>(node_rows) + 4 * node;
  const float4 a = __ldg(row);      // min.xyz, max.x
  const float4 b = __ldg(row + 1);  // max.yz, count, miss
  const float4 c = __ldg(row + 2);  // slot8, slot9, pad, pad
  *ints = make_int4(__float_as_int(b.z), __float_as_int(b.w),
                    __float_as_int(c.x), __float_as_int(c.y));
  const float t1x = (a.x - r.ox) * r.ix, t2x = (a.w - r.ox) * r.ix;
  const float t1y = (a.y - r.oy) * r.iy, t2y = (b.x - r.oy) * r.iy;
  const float t1z = (a.z - r.oz) * r.iz, t2z = (b.y - r.oz) * r.iz;
  const float tn = max_nan(
      max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)), min_nan(t1z, t2z));
  const float tf = min_nan(
      min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)), max_nan(t1z, t2z));
  return tf >= max_nan(tn, 0.0f) && tn < bound;
}

// Moller-Trumbore, products in the reference's order. Returns true where
// it is a hit in (kTMin, bound).
__device__ __forceinline__ bool mt_hit(float p0x, float p0y, float p0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       const Ray& r, float bound, float* uo,
                                       float* vo, float* to) {
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
  const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *uo = u;
  *vo = v;
  *to = t;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin && t < bound;
}

// The triangle at float offset S of the 12 floats q[0..2]: three aligned
// 16-byte loads. Returns true where it is a hit in (kTMin, bound).
template <int S>
__device__ __forceinline__ bool tri_window(const float4* q, const Ray& r,
                                           float bound, float* u, float* v,
                                           float* t) {
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                       b.z, b.w, c.x, c.y, c.z, c.w};
  return mt_hit(w[S], w[S + 1], w[S + 2], w[S + 3], w[S + 4], w[S + 5],
                w[S + 6], w[S + 7], w[S + 8], r, bound, u, v, t);
}

template <int S>
__device__ __forceinline__ bool tri_window(const float4* q, const Ray& r,
                                           float bound) {
  float u, v, t;
  return tri_window<S>(q, r, bound, &u, &v, &t);
}

// K2's fold of triangle `tri` (the window at q): the strict t < best keeps
// the earlier of two triangles at the same t, as the twin's first minimum
// does.
template <int S>
__device__ __forceinline__ bool fold_tri(const float4* q, const Ray& r,
                                         int tri, float* best, float* bu,
                                         float* bv, int* btri) {
  float u, v, t;
  if (!tri_window<S>(q, r, *best, &u, &v, &t)) return false;
  *best = t;
  *bu = u;
  *bv = v;
  *btri = tri;
  return true;
}

// K2: the leaf row's first n triangles (ids from `first`) folded into the
// ray's closest hit, in the row's order. Returns true where one hit.
__device__ __forceinline__ bool leaf_closest(const float* __restrict__ leaf,
                                             int n, int first, const Ray& r,
                                             float* best, float* bu,
                                             float* bv, int* btri) {
  const float4* q = reinterpret_cast<const float4*>(leaf);
  n = n < kLeafCap ? n : kLeafCap;
  bool hit = false;
  for (int g = 0; 4 * g < n; ++g, q += 9) {
    const int k = first + 4 * g;
    hit |= fold_tri<0>(q, r, k, best, bu, bv, btri);
    if (4 * g + 1 < n) hit |= fold_tri<1>(q + 2, r, k + 1, best, bu, bv, btri);
    if (4 * g + 2 < n) hit |= fold_tri<2>(q + 4, r, k + 2, best, bu, bv, btri);
    if (4 * g + 3 < n) hit |= fold_tri<3>(q + 6, r, k + 3, best, bu, bv, btri);
  }
  return hit;
}

// True where one of the leaf row's first n triangles blocks [kTMin,
// bound). Triangle 4g + k starts at float 36g + 9k = 4 (9g + 2k) + k.
__device__ __forceinline__ bool leaf_blocks(const float* __restrict__ leaf,
                                            int n, const Ray& r,
                                            float bound) {
  const float4* q = reinterpret_cast<const float4*>(leaf);
  n = n < kLeafCap ? n : kLeafCap;
  for (int g = 0; 4 * g < n; ++g, q += 9) {
    if (tri_window<0>(q, r, bound)) return true;
    if (4 * g + 1 < n && tri_window<1>(q + 2, r, bound)) return true;
    if (4 * g + 2 < n && tri_window<2>(q + 4, r, bound)) return true;
    if (4 * g + 3 < n && tri_window<3>(q + 6, r, bound)) return true;
  }
  return false;
}

}  // namespace
