// K1: wide-BVH (8-ary) ray traversal, closest-hit and any-hit modes.
//
// Replaces the TPU kernel loupiote_tpu/ops/pallas_wide.py::_wide_kernel
// (launched by _wide_trace, wrapped by intersect_wide / occluded_wide).
// It computes what that kernel computes, not how: one thread per ray,
// a private stack in local memory, no 128-lane sub-packets, no deferred
// leaf flushes. The plain torch twin is
// loupiote_tpu_torch/ops/wide.py::wide_trace_plain; both follow the same
// visit order, so they agree bit for bit, ties included.
//
// Table (loupiote_tpu_torch/accel/wide.py): rows of 128 floats. An
// internal row holds child c in floats [16c, 16c+7): min.xyz, max.xyz,
// then a bitcast int32 pointer (-1 = empty slot, bit 1<<30 = leaf row).
// A leaf row holds up to 14 triangles as p0/e1/e2 in floats [0, 126);
// float 126 is the bitcast int (first << 4 | count). Row 0 is internal.
// Pointers are read with __float_as_int only: a -1 pointer is a NaN bit
// pattern that any float operation could canonicalise.
//
// What bounds it on an H100: each step is a dependent load of one
// 512-byte row (the next row's address comes out of this one), then a
// few dozen flops. Rays of a warp diverge to different rows and different
// step counts. So it is latency and divergence bound, not flop or
// bandwidth bound: the arch-260k table (15,638,528 bytes as chip_smoke.py
// prints it) fits the 50 MB L2, and the rays of a coherent warp share
// each row load in L1. The design answers latency only with occupancy:
// 128 threads a block, one wave of up to ~2M rays. Coherence comes from
// the callers, which sort rays between bounces.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py). --fmad=false keeps every product
// separately rounded as in the reference, so t agrees within 2 ulp and
// every edge decision is the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStackMax = 64;  // ops/wide.py raises if scene.wide_stack > 64
constexpr int kLeafTag = 1 << 30;
constexpr int kLeafMask = kLeafTag - 1;
constexpr int kRow = 128;
constexpr float kTMin = 1e-4f;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(128)
    wide_traverse_kernel(const float* __restrict__ rows,
                         const float* __restrict__ ro,
                         const float* __restrict__ rd,
                         const float* __restrict__ tmax,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ t_out,
                         int32_t* __restrict__ tri_out,
                         int32_t* __restrict__ capped, int n_rays,
                         int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
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
    int stack[kStackMax];
    int sp = 0;
    int cur = 0;
    for (int steps = 0;; ++steps) {
      if (steps == max_steps) {  // the reference's silent step bound
        atomicAdd(capped, 1);
        break;
      }
      const float* row = rows + static_cast<size_t>(cur & kLeafMask) * kRow;
      int next = -1;  // -1: pop the stack
      if (cur & kLeafTag) {
        const int fc = __float_as_int(__ldg(row + 126));
        const int count = fc & 15;
        const int first = fc >> 4;
        for (int k = 0; k < count; ++k) {
          const float* tr = row + 9 * k;
          const float p0x = __ldg(tr + 0), p0y = __ldg(tr + 1),
                      p0z = __ldg(tr + 2);
          const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4),
                      e1z = __ldg(tr + 5);
          const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7),
                      e2z = __ldg(tr + 8);
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
          // Strict t < best keeps the earlier triangle on a tie.
          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin &&
              t < best) {
            if (kAnyHit) {
              blocked = true;
              break;
            }
            best = t;
            best_tri = first + k;
          }
        }
        if (kAnyHit && blocked) break;
      } else {
        const float bound = kAnyHit ? t0 : best;
        const float4* r4 = reinterpret_cast<const float4*>(row);
        int ptrs[8];
        unsigned hit = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 a = __ldg(r4 + 4 * c);      // min.xyz, max.x
          const float4 b = __ldg(r4 + 4 * c + 1);  // max.yz, ptr, pad
          const int ptr = __float_as_int(b.z);
          ptrs[c] = ptr;
          const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
          const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
          const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
          const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                 fminf(t1z, t2z));
          const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                 fmaxf(t1z, t2z));
          if (ptr != -1 && tf >= fmaxf(tn, 0.0f) && tn < bound) hit |= 1u << c;
        }
        // Push the hit children far-to-near; the nearest one is visited
        // next without a round trip through the stack.
        for (int p = 7; p >= 0; --p) {
          const int c = p ^ oct;
          if (!((hit >> c) & 1u)) continue;
          if (next >= 0) stack[sp++] = next;
          next = ptrs[c];
        }
      }
      if (next >= 0) {
        cur = next;
      } else {
        if (sp == 0) break;
        cur = stack[--sp];
      }
    }
  }
  t_out[i] = best;
  tri_out[i] = kAnyHit ? (blocked ? 1 : 0) : best_tri;
}

}  // namespace

// C entry point (ctypes). Pointers come from tensor.data_ptr(); the
// stream is torch.cuda.current_stream().cuda_stream. Returns
// cudaGetLastError() after the launch; allocates nothing, does not sync.
extern "C" int wide_traverse(const void* rows, const void* ro, const void* rd,
                             const void* tmax, const void* active, void* t_out,
                             void* tri_out, void* capped, int n_rays,
                             int max_steps, int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((n_rays + 127) / 128);
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
    wide_traverse_kernel<true>
        <<<grid, block, 0, s>>>(r, o, d, tm, act, t, tri, cap, n_rays,
                                max_steps);
  } else {
    wide_traverse_kernel<false>
        <<<grid, block, 0, s>>>(r, o, d, tm, act, t, tri, cap, n_rays,
                                max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
