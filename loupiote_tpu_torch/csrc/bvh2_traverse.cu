// K2 and K3: BVH2 ray traversal.
//
// K2 (bvh2_trace) replaces the TPU kernel
// loupiote_tpu/ops/pallas_intersect.py::_traverse_kernel (launched by
// _pallas_trace, wrapped by intersect_pallas): closest hit (t, u, v, tri),
// or any-hit, with a stack. K3 (bvh2_occluded) replaces
// loupiote_tpu/ops/pallas_intersect.py::_anyhit_kernel (launched by
// _pallas_anyhit, wrapped by occluded_pallas): one blocked bit per ray,
// stackless over the threaded miss links. Both compute what those kernels
// compute, not how: one thread per ray, no 128-ray sub-packets. K2 picks
// the near child by the ray's own direction sign along the split axis
// (the TPU kernel takes a sub-packet's majority sign); order moves only
// step counts and which of two triangles at the same t wins. K3 retires
// each ray on its own. The plain torch twins are
// loupiote_tpu_torch/ops/bvh2.py::bvh2_trace_plain and
// ::bvh2_occluded_plain; they follow the same visit order and arithmetic,
// so a kernel and its twin agree bit for bit.
//
// Tables (loupiote_tpu_torch/scene/buffers.py): node_rows (N, 16) floats:
// min.xyz, max.xyz, then bitcast ints count (0 = internal), miss,
// right child (internal) or leaf row (leaf), split axis (internal) or
// first triangle (leaf). leaf_rows (L, 128): up to 14 triangles as
// p0/e1/e2, empty slots at p0 = 1e30; only the first `count` are tested.
// The left child of internal node n is n + 1. Ints are read with
// __float_as_int only: a -1 is a NaN bit pattern.
//
// What bounds them on an H100: each step is a dependent load of one
// 64-byte node row (and, at a leaf, one 512-byte leaf row), then a few
// dozen flops. The tables of a small scene are small (arch-40k: about
// 0.5 MB of nodes and 2 MB of leaves) and stay in the 50 MB L2; a 960x540
// wave is about 15 MB of ray input, read once. So the kernels are bound
// by load latency and warp divergence, not by bytes or flops: a warp runs
// every kind of step its lanes need (a node's box test, a leaf's up to 14
// triangle tests) for as many steps as its longest ray. Both kernels were
// redesigned for that divergence (each choice timed on the card against
// its alternatives; PERF.md has the numbers):
//  - Leaf rows wait: a lane walks internal nodes until it reaches a hit
//    leaf, and the warp tests leaves when every lane holds one or is done,
//    so the triangle loop runs with the lanes together. A waiting lane
//    takes no step, so each ray's own order of nodes, the bound of each of
//    its box tests (K2's best t) and its step count are the twin's.
//  - A leaf's triangles are read as 16-byte words: triangle 4g + k starts
//    at float 36g + 9k, so three aligned float4 loads from float4 9g + 2k
//    hold it at offset k (three loads a triangle in place of nine).
//  - K2 keeps its stack in a 128-entry local array (a 512-byte frame that
//    L1 serves): a shared-memory stack sized to the table's depth (one
//    word a level, no bank conflicts) was 2.6% slower on the interactive
//    frame's waves, and a 32-entry local array no faster (NVIDIA H100
//    80GB HBM3, 700 W; PERF.md).
//  - Blocks of 64 threads for both. A near-first order with a stack, and
//    a warp that visits one node a step for all its lanes (the TPU
//    kernel's shape), were slower for K3.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py). --fmad=false keeps every product
// separately rounded as in the reference, so t, u, v and every edge
// decision match the twins.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh2_lane.cuh"

namespace {

constexpr int kTraceThreads = 64;  // K2's block
constexpr int kOccThreads = 64;  // K3's block
constexpr unsigned kFull = 0xffffffffu;

// K2. node: the next node of the ray's near-first walk (-1: the walk has
// ended); ln > 0: a hit leaf (row lrow, ln triangles from id lfirst) waits
// to be tested. At a hit leaf the lane pops its next node at once (the pop
// does not read best) but takes no step until the warp has tested the
// leaf, so its next box test reads the best t the leaf left, and a leaf
// visited before the step bound is tested before the bound can stop the
// ray: the hits and the counts are the twin's. An any-hit lane ends at a
// leaf with a hit, after the whole leaf, whose closest hit it returns as
// the twin does.
template <bool kAnyHit>
__global__ void __launch_bounds__(kTraceThreads)
    bvh2_trace_kernel(const float* __restrict__ node_rows,
                      const float* __restrict__ leaf_rows,
                      const float* __restrict__ ro,
                      const float* __restrict__ rd,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active,
                      float* __restrict__ t_out, float* __restrict__ u_out,
                      float* __restrict__ v_out,
                      int32_t* __restrict__ tri_out,
                      int32_t* __restrict__ capped, int n_rays,
                      int max_steps) {
  // Every lane of the warp stays to the end: the loops vote.
  const int i = blockIdx.x * kTraceThreads + threadIdx.x;
  const bool in = i < n_rays;
  float best = in ? tmax[i] : 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  int node = (in && active[i]) ? 0 : -1;
  Ray r = {};
  if (node == 0) r = load_ray(ro, rd, i);
  int stack[kStackMax];
  int sp = 0, lrow = 0, ln = 0, lfirst = 0, steps = 0;
  for (;;) {
    // Walk internal nodes until every lane holds a leaf or is done.
    while (__any_sync(kFull, node >= 0 && ln == 0)) {
      if (node >= 0 && ln == 0) {
        if (steps == max_steps) {  // the reference's silent step bound
          atomicAdd(capped, 1);
          node = -1;
        } else {
          ++steps;
          int4 ints;  // count, miss, slot8, slot9
          const bool hit = slab(node_rows, node, r, best, &ints);
          if (hit && ints.x == 0) {
            // Internal: near child first by the direction sign on the
            // split axis; the far one waits on the stack.
            const float dax =
                ints.w == 0 ? r.dx : (ints.w == 1 ? r.dy : r.dz);
            const int left = node + 1, right = ints.z;
            const bool pos = dax >= 0.0f;
            stack[sp++] = pos ? right : left;
            node = pos ? left : right;
          } else {
            if (hit) {
              lrow = ints.z;
              ln = ints.x;
              lfirst = ints.w;
            }
            node = sp > 0 ? stack[--sp] : -1;
          }
        }
      }
    }
    if (!__any_sync(kFull, ln > 0)) break;
    if (ln > 0) {
      if (leaf_closest(leaf_rows + static_cast<size_t>(lrow) * 128, ln,
                       lfirst, r, &best, &best_u, &best_v, &best_tri) &&
          kAnyHit) {
        node = -1;
      }
      ln = 0;
    }
  }
  if (in) {
    t_out[i] = best;
    u_out[i] = best_u;
    v_out[i] = best_v;
    tri_out[i] = best_tri;
  }
}

// K3. node: the next node of the ray's pre-order walk (-1: the walk has
// ended); ln > 0: a hit leaf (row lrow, ln triangles) waits to be tested.
// A lane steps only with no leaf waiting, so a leaf visited before the
// step bound is tested before the bound can stop the ray: the counts and
// the blocked bits are the twin's.
__global__ void __launch_bounds__(kOccThreads)
    bvh2_occluded_kernel(const float* __restrict__ node_rows,
                         const float* __restrict__ leaf_rows,
                         const float* __restrict__ ro,
                         const float* __restrict__ rd,
                         const float* __restrict__ tmax,
                         const uint8_t* __restrict__ active,
                         int32_t* __restrict__ blocked_out,
                         int32_t* __restrict__ capped, int n_rays,
                         int max_steps, int end_index) {
  // Every lane of the warp stays to the end: the loops vote.
  const int i = blockIdx.x * kOccThreads + threadIdx.x;
  const bool in = i < n_rays;
  int node = (in && active[i]) ? 0 : -1;
  Ray r = {};
  float t0 = 0.0f;
  if (node == 0) {
    r = load_ray(ro, rd, i);
    t0 = tmax[i];
  }
  int lrow = 0, ln = 0, steps = 0, blocked = 0;
  for (;;) {
    // Walk internal nodes until every lane holds a leaf or is done.
    while (__any_sync(kFull, node >= 0 && ln == 0)) {
      if (node >= 0 && ln == 0) {
        if (steps == max_steps) {  // the reference's silent step bound
          atomicAdd(capped, 1);
          node = -1;
        } else {
          ++steps;
          int4 ints;  // count, miss, slot8, slot9
          const bool hit = slab(node_rows, node, r, t0, &ints);
          if (hit && ints.x > 0) {
            lrow = ints.z;
            ln = ints.x;
          }
          const int next = (hit && ints.x == 0) ? node + 1 : ints.y;
          node = next < end_index ? next : -1;
        }
      }
    }
    if (!__any_sync(kFull, ln > 0)) break;
    if (ln > 0) {
      if (leaf_blocks(leaf_rows + static_cast<size_t>(lrow) * 128, ln, r,
                      t0)) {
        blocked = 1;
        node = -1;
      }
      ln = 0;
    }
  }
  if (in) blocked_out[i] = blocked;
}

}  // namespace

// C entry points (ctypes). Pointers come from tensor.data_ptr(); the
// stream is torch.cuda.current_stream().cuda_stream. Each returns
// cudaGetLastError() after its launch; allocates nothing, does not sync.
extern "C" int bvh2_trace(const void* node_rows, const void* leaf_rows,
                          const void* ro, const void* rd, const void* tmax,
                          const void* active, void* t_out, void* u_out,
                          void* v_out, void* tri_out, void* capped,
                          int n_rays, int max_steps, int any_hit,
                          void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 block(kTraceThreads);
  const dim3 grid((n_rays + kTraceThreads - 1) / kTraceThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nr = static_cast<const float*>(node_rows);
  auto* lr = static_cast<const float*>(leaf_rows);
  auto* o = static_cast<const float*>(ro);
  auto* d = static_cast<const float*>(rd);
  auto* tm = static_cast<const float*>(tmax);
  auto* act = static_cast<const uint8_t*>(active);
  auto* t = static_cast<float*>(t_out);
  auto* u = static_cast<float*>(u_out);
  auto* v = static_cast<float*>(v_out);
  auto* tri = static_cast<int32_t*>(tri_out);
  auto* cap = static_cast<int32_t*>(capped);
  if (any_hit) {
    bvh2_trace_kernel<true><<<grid, block, 0, s>>>(
        nr, lr, o, d, tm, act, t, u, v, tri, cap, n_rays, max_steps);
  } else {
    bvh2_trace_kernel<false><<<grid, block, 0, s>>>(
        nr, lr, o, d, tm, act, t, u, v, tri, cap, n_rays, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh2_occluded(const void* node_rows, const void* leaf_rows,
                             const void* ro, const void* rd, const void* tmax,
                             const void* active, void* blocked_out,
                             void* capped, int n_rays, int max_steps,
                             int end_index, void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 block(kOccThreads);
  const dim3 grid((n_rays + kOccThreads - 1) / kOccThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bvh2_occluded_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(node_rows),
      static_cast<const float*>(leaf_rows), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(tmax),
      static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(blocked_out), static_cast<int32_t*>(capped),
      n_rays, max_steps, end_index);
  return static_cast<int>(cudaGetLastError());
}
