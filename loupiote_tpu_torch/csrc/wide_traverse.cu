// K1: wide-BVH (8-ary) ray traversal, closest-hit and any-hit modes.
//
// Replaces the TPU kernel loupiote_tpu/ops/pallas_wide.py::_wide_kernel
// (launched by _wide_trace, wrapped by intersect_wide / occluded_wide).
// It computes what that kernel computes, not how: one thread per ray,
// no 128-lane sub-packets, no deferred leaf flushes. The plain torch twin
// is loupiote_tpu_torch/ops/wide.py::wide_trace_plain; both follow the
// same visit order, so they agree bit for bit, ties included.
//
// Table (loupiote_tpu_torch/accel/wide.py): rows of 128 floats. An
// internal row holds child c in floats [16c, 16c+7): min.xyz, max.xyz,
// then a bitcast int32 pointer (-1 = empty slot, bit 1<<30 = leaf row).
// A leaf row holds up to 14 triangles as p0/e1/e2 in floats [0, 126);
// float 126 is the bitcast int (first << 4 | count). Row 0 is internal.
// Pointers are read with __float_as_int only: a -1 pointer is a NaN bit
// pattern that any float operation could canonicalise.
//
// Visit order (the twin's): at an internal row the hit children are
// ranked by priority p = slot ^ octant(ray direction); the first goes
// next, the others wait on the stack and are popped in priority order
// after the first one's subtree is done.
//
// What bounds it on an H100: each step is a dependent load of one
// 512-byte row (the next row's address comes out of this one), then a
// few dozen flops; the arch-260k table (15,638,528 bytes) fits the 50 MB
// L2, and the rays of a coherent warp share each row load in L1. The
// lanes of a warp run different kinds of step (an internal row's 8 box
// tests, a leaf row's up to 14 triangle tests) and different numbers of
// them, and a warp runs every kind its lanes need. What the design does
// (each choice timed on the card against its alternatives; PERF.md has
// the numbers):
//  - Leaf rows wait: a lane walks internal rows until it reaches a leaf
//    row, and the warp tests leaf rows when all its lanes hold one or are
//    done, so the triangle loop runs with the lanes together. Each ray's
//    own order of rows is unchanged.
//  - One stack entry per level, not per child: the parent row and the
//    mask of its hit children not yet visited, in one 32-bit word
//    (row << 8 | mask by priority). A pop takes the mask's lowest bit and
//    re-reads that child's pointer from the parent row, most likely
//    still in L1. The stack needs the tree's depth in internal rows
//    (ops/wide.py computes it from the table), so it lives in shared
//    memory, depth x 128 x 4 bytes a block, not in local memory.
//  - No per-child pointer array, and at most 48 registers a thread (10
//    blocks of 128 threads an SM).
// Coherence comes from the callers, which sort rays between bounces.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py). --fmad=false keeps every product
// separately rounded as in the reference, so t agrees within 2 ulp and
// every edge decision is the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 10;  // resident blocks an SM: <= 48 registers
constexpr int kDepthMax = 32;  // ops/wide.py: DEPTH_MAX
constexpr int kLeafTag = 1 << 30;
constexpr int kLeafMask = kLeafTag - 1;
constexpr int kRow = 128;
constexpr float kTMin = 1e-4f;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

// Child c's pointer in internal row r.
__device__ __forceinline__ int child_ptr(const float* rows, int r, int c) {
  return __float_as_int(
      __ldg(rows + static_cast<size_t>(r) * kRow + 16 * c + 6));
}

// A leaf row's triangles against the ray, in slot order; strict t < best
// keeps the earlier triangle on a tie. Returns true where any-hit mode
// found a blocker.
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_row(const float* row, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& best,
                                         int& best_tri) {
  const int fc = __float_as_int(__ldg(row + 126));
  const int count = fc & 15;
  const int first = fc >> 4;
  for (int k = 0; k < count; ++k) {
    const float* tr = row + 9 * k;
    const float p0x = __ldg(tr + 0), p0y = __ldg(tr + 1), p0z = __ldg(tr + 2);
    const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
    const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
    // Moller-Trumbore, products in the reference's order.
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
    const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin && t < best) {
      if (kAnyHit) return true;
      best = t;
      best_tri = first + k;
    }
  }
  return false;
}

// An internal row: box-test the 8 children against bound, push the hit
// ones but the nearest as one entry, return the nearest (-1: none hit).
__device__ __forceinline__ int internal_row(const float* rows, int cur,
                                            float ox, float oy, float oz,
                                            float ix, float iy, float iz,
                                            int oct, float bound,
                                            uint32_t* stack, int& sp) {
  const float4* r4 =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(cur) * kRow);
  unsigned pmask = 0;  // hit children, bit p = slot p ^ oct
  int near_p = 8;      // the first of them and its pointer
  int next = -1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 a = __ldg(r4 + 4 * c);      // min.xyz, max.x
    const float4 b = __ldg(r4 + 4 * c + 1);  // max.yz, ptr, pad
    const int ptr = __float_as_int(b.z);
    const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
    const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
    const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
    const float tn = max_nan(
        max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)), min_nan(t1z, t2z));
    const float tf = min_nan(
        min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)), max_nan(t1z, t2z));
    const int p = c ^ oct;
    if (ptr != -1 && tf >= max_nan(tn, 0.0f) && tn < bound) {
      pmask |= 1u << p;
      if (p < near_p) {
        near_p = p;
        next = ptr;
      }
    }
  }
  pmask &= pmask - 1;  // the rest wait as one entry
  if (pmask) stack[kThreads * sp++] = (cur << 8) | pmask;
  return next;
}

// The next row from the stack: the top entry's first waiting child,
// whose pointer is re-read from the parent row (-1: the stack is empty).
__device__ __forceinline__ int pop(const float* rows, uint32_t* stack,
                                   int& sp, int oct) {
  if (sp == 0) return -1;
  uint32_t* top = stack + kThreads * (sp - 1);
  const uint32_t e = *top;
  const uint32_t mask = e & 0xFFu;
  const uint32_t rest = mask & (mask - 1);
  if (rest) {
    *top = (e & ~0xFFu) | rest;
  } else {
    --sp;
  }
  return child_ptr(rows, static_cast<int>(e >> 8), (__ffs(mask) - 1) ^ oct);
}

// One ray, start to end. stack: this thread's entries, entry d at
// stack[d * kThreads]. The ray walks internal rows until it reaches a
// leaf row, then tests it: the lanes of a warp test their leaf rows
// together.
template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(
    const float* __restrict__ rows, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ tmax,
    const uint8_t* __restrict__ active, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, int32_t* __restrict__ capped,
    uint32_t* stack, int i, int max_steps) {
  const float t0 = tmax[i];
  float best = t0;
  int best_tri = -1;
  bool blocked = false;
  if (active[i]) {
    const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
    const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    // Children sit at octant-coded slots: visiting slot c ^ oct in
    // ascending order goes roughly near-to-far for this ray.
    const int oct = (dx < 0.0f) | ((dy < 0.0f) << 1) | ((dz < 0.0f) << 2);
    int sp = 0;
    int cur = 0;  // -1: done
    int steps = 0;
    while (cur >= 0) {
      while (cur >= 0 && !(cur & kLeafTag)) {
        if (steps++ == max_steps) {  // the reference's silent step bound
          atomicAdd(capped, 1);
          cur = -1;
          break;
        }
        const int next = internal_row(rows, cur, ox, oy, oz, ix, iy, iz, oct,
                                      kAnyHit ? t0 : best, stack, sp);
        cur = next >= 0 ? next : pop(rows, stack, sp, oct);
      }
      if (cur < 0) break;
      if (steps++ == max_steps) {
        atomicAdd(capped, 1);
        break;
      }
      if (leaf_row<kAnyHit>(rows + static_cast<size_t>(cur & kLeafMask) * kRow,
                            ox, oy, oz, dx, dy, dz, best, best_tri)) {
        blocked = true;
        break;
      }
      cur = pop(rows, stack, sp, oct);
    }
  }
  t_out[i] = best;
  tri_out[i] = kAnyHit ? (blocked ? 1 : 0) : best_tri;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wide_traverse_kernel(const float* __restrict__ rows,
                         const float* __restrict__ ro,
                         const float* __restrict__ rd,
                         const float* __restrict__ tmax,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ t_out,
                         int32_t* __restrict__ tri_out,
                         int32_t* __restrict__ capped, int n_rays,
                         int max_steps) {
  extern __shared__ uint32_t stacks[];  // [depth][kThreads]
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  trace_ray<kAnyHit>(rows, ro, rd, tmax, active, t_out, tri_out, capped,
                     stacks + threadIdx.x, i, max_steps);
}

}  // namespace

// C entry point (ctypes). Pointers come from tensor.data_ptr(); the
// stream is torch.cuda.current_stream().cuda_stream. depth: the table's
// depth in internal rows, at most kDepthMax; every row index below 2^24.
// Returns cudaGetLastError() after the launch; allocates nothing, does
// not sync.
extern "C" int wide_traverse(const void* rows, const void* ro, const void* rd,
                             const void* tmax, const void* active, void* t_out,
                             void* tri_out, void* capped, int n_rays,
                             int max_steps, int depth, int any_hit,
                             void* stream) {
  if (n_rays <= 0) return 0;
  if (depth < 1 || depth > kDepthMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kThreads);
  const dim3 grid((n_rays + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(depth) * kThreads * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<const float*>(ro);
  auto* d = static_cast<const float*>(rd);
  auto* tm = static_cast<const float*>(tmax);
  auto* act = static_cast<const uint8_t*>(active);
  auto* t = static_cast<float*>(t_out);
  auto* tri = static_cast<int32_t*>(tri_out);
  auto* cap = static_cast<int32_t*>(capped);
  if (any_hit) {
    wide_traverse_kernel<true><<<grid, block, smem, s>>>(
        r, o, d, tm, act, t, tri, cap, n_rays, max_steps);
  } else {
    wide_traverse_kernel<false><<<grid, block, smem, s>>>(
        r, o, d, tm, act, t, tri, cap, n_rays, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
