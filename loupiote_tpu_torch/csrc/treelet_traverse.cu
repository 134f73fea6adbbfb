// E6 and E7: the two per-lane walks of the treelet traversal.
//
// E6 replaces the TPU kernel experiments/treelet/lane_top.py::
// _lane_top_kernel (launched by _lane_top_trace, wrapped by
// lane_top_trace): each ray walks the threaded top of the BVH2 and
// collects up to 8 ids of the subtrees whose root boxes it enters.
// E7 replaces experiments/treelet/lane_bottom.py::_lane_bottom_kernel
// (wrapped by lane_bottom_trace): each (ray, subtree) pair walks its
// subtree, node boxes and triangles, to (t, tri_local); closest-hit or
// any-hit. The plain twins are loupiote_tpu_torch/treelet/lane_top.py::
// lane_top_plain and lane_bottom.py::lane_bottom_plain; kernel and twin
// take the same steps with the same arithmetic, so they agree bit for bit.
//
// Tables (loupiote_tpu_torch/treelet/build.py), float32 with ints bitcast:
//   top (8, Ktiles * 1024): min.xyz, max.xyz, link = hit | miss << 12,
//       pend = subtree id of a frontier entry (-1 in the top);
//   sub (11, S + 1, 1024): per subtree entry min.xyz / p0.xyz, max.xyz /
//       e1.xyz, e2.xyz, link = hit | miss << 10 | is_tri << 20 |
//       local << 21; field 10 is not read here.
// link and pend words are read with __float_as_int only. A subtree link
// with local >= 1020 sets every exponent bit (a NaN or Inf pattern), which
// float arithmetic could canonicalise.
//
// What bounds them on an H100: like K1, each step is a dependent load of
// one entry (the next entry's id comes out of this one) and a few dozen
// flops, with the rays of a warp on different entries and step counts, so
// latency and divergence, not bytes or flops. E6 reads the top table
// through L1 (32 KB for arch-260k; at most 8 x 4,096 entries = 128 KB).
// E7 stages the block's subtree (10 fields x 1,024 entries = 40 KB) in
// shared memory, the counterpart of the TPU kernel's scalar-prefetched
// VMEM tile: each 1,024-pair block of the pair layout holds pairs of one
// subtree, and runs as two CUDA blocks of 512 threads that read the same
// sid and stage the same subtree.
//
// Step bounds: E6 4 * num_top + 64, E7 2048 (the reference's). The
// reference stops such lanes silently; here every lane that reaches the
// bound adds one to a counter.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py). --fmad=false keeps every product
// separately rounded, as in the twins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPendCap = 8;      // treelet/build.py: PEND_CAP
constexpr int kTopIdBits = 12;   // treelet/build.py: TOP_ID_BITS
constexpr int kIdMask = (1 << kTopIdBits) - 1;
constexpr int kSubEnd = 1023;    // treelet/build.py: SUB_END
constexpr int kTile = 1024;      // entries per subtree; pairs per block
constexpr int kWalkFields = 10;  // f0..f9
constexpr int kTopThreads = 128;
constexpr int kBottomThreads = 512;
constexpr float kTMin = 1e-4f;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

// Slab test, in the order of the reference: t1 = (min - o) * inv, ...
__device__ __forceinline__ void slab(float mnx, float mny, float mnz,
                                     float mxx, float mxy, float mxz,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float* tn,
                                     float* tf) {
  const float t1x = (mnx - ox) * ix, t2x = (mxx - ox) * ix;
  const float t1y = (mny - oy) * iy, t2y = (mxy - oy) * iy;
  const float t1z = (mnz - oz) * iz, t2z = (mxz - oz) * iz;
  *tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  *tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

__global__ void __launch_bounds__(kTopThreads)
    lane_top_kernel(const float* __restrict__ top, int top_stride,
                    const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ tmax,
                    const uint8_t* __restrict__ active,
                    int32_t* __restrict__ pend_out,
                    int32_t* __restrict__ npend_out,
                    int32_t* __restrict__ capped, int n_rays,
                    int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int32_t* pend = pend_out + static_cast<size_t>(i) * kPendCap;
#pragma unroll
  for (int p = 0; p < kPendCap; ++p) pend[p] = -1;
  int np = 0;
  if (active[i]) {
    const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
    const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const float t0 = tmax[i];
    int cur = 0;
    for (int steps = 0; cur != kIdMask; ++steps) {
      if (steps == max_steps) {  // the reference's silent step bound
        atomicAdd(capped, 1);
        break;
      }
      float tn, tf;
      slab(__ldg(top + cur), __ldg(top + top_stride + cur),
           __ldg(top + 2 * top_stride + cur), __ldg(top + 3 * top_stride + cur),
           __ldg(top + 4 * top_stride + cur), __ldg(top + 5 * top_stride + cur),
           ox, oy, oz, ix, iy, iz, &tn, &tf);
      const int link = __float_as_int(__ldg(top + 6 * top_stride + cur));
      const int pe = __float_as_int(__ldg(top + 7 * top_stride + cur));
      const bool hit = tf >= fmaxf(tn, 0.0f) && tn < t0;
      const int hit_id = link & kIdMask;
      const int miss_id = (link >> kTopIdBits) & kIdMask;
      if (hit && pe >= 0) {
        if (np >= kPendCap) {  // all slots full: park the lane at END
          cur = kIdMask;
          continue;
        }
        pend[np++] = pe;
      }
      cur = (hit && hit_id != kIdMask) ? hit_id : miss_id;
    }
  }
  npend_out[i] = np;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBottomThreads)
    lane_bottom_kernel(const int32_t* __restrict__ sid_blocks,
                       const float* __restrict__ sub, int sub_stride,
                       const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ tmax,
                       const int32_t* __restrict__ active,
                       float* __restrict__ t_out,
                       int32_t* __restrict__ tri_out,
                       int32_t* __restrict__ capped, int max_steps) {
  __shared__ float f[kWalkFields][kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // pair
  const int sid = sid_blocks[i / kTile];  // the same for the whole block
  const float* tile = sub + static_cast<size_t>(sid) * kTile;
  for (int e = threadIdx.x; e < kWalkFields * kTile; e += blockDim.x) {
    f[e / kTile][e % kTile] =
        __ldg(tile + static_cast<size_t>(e / kTile) * sub_stride + e % kTile);
  }
  __syncthreads();
  const float t0 = tmax[i];
  float best = t0;
  int best_tri = -1;
  if (active[i] > 0) {
    const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
    const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int cur = 0;
    for (int steps = 0; cur != kSubEnd; ++steps) {
      if (steps == max_steps) {  // the reference's silent step bound
        atomicAdd(capped, 1);
        break;
      }
      const int link = __float_as_int(f[9][cur]);
      const int hit_id = link & 1023;
      const int miss_id = (link >> 10) & 1023;
      if ((link >> 20) & 1) {
        // Moller-Trumbore, products in the order of ops/intersect.py.
        const float p0x = f[0][cur], p0y = f[1][cur], p0z = f[2][cur];
        const float e1x = f[3][cur], e1y = f[4][cur], e1z = f[5][cur];
        const float e2x = f[6][cur], e2y = f[7][cur], e2z = f[8][cur];
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
        if (fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f &&
            u + v <= 1.0f && t > kTMin && t < best) {
          best = t;
          best_tri = (link >> 21) & 1023;
          if (kAnyHit) break;  // the first accepted triangle ends the walk
        }
        cur = miss_id;  // a triangle entry holds its next id in both slots
      } else {
        float tn, tf;
        slab(f[0][cur], f[1][cur], f[2][cur], f[3][cur], f[4][cur], f[5][cur],
             ox, oy, oz, ix, iy, iz, &tn, &tf);
        cur = (tf >= fmaxf(tn, 0.0f) && tn < best) ? hit_id : miss_id;
      }
    }
  }
  t_out[i] = best;
  tri_out[i] = best_tri;
}

}  // namespace

// C entry points (ctypes). Pointers come from tensor.data_ptr(); the
// stream is torch.cuda.current_stream().cuda_stream. Each returns
// cudaGetLastError() after its launch; allocates nothing, does not sync.

// top: (8, top_stride) f32; ro, rd (n, 3) f32; tmax (n,) f32; active (n,)
// bool; pend (n, 8) i32; npend (n,) i32; capped: one i32 counter.
extern "C" int lane_top(const void* top, int top_stride, const void* ro,
                        const void* rd, const void* tmax, const void* active,
                        void* pend, void* npend, void* capped, int n_rays,
                        int max_steps, void* stream) {
  if (n_rays <= 0) return 0;
  lane_top_kernel<<<(n_rays + kTopThreads - 1) / kTopThreads, kTopThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(top), top_stride,
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(tmax), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(pend), static_cast<int32_t*>(npend),
      static_cast<int32_t*>(capped), n_rays, max_steps);
  return static_cast<int>(cudaGetLastError());
}

// sid_blocks (n_pairs / 1024,) i32; sub: (11, sub_stride) f32 with
// sub_stride = (S + 1) * 1024; ro, rd (n_pairs, 3) f32; tmax (n_pairs,)
// f32; active (n_pairs,) i32; t (n_pairs,) f32; tri (n_pairs,) i32;
// capped: one i32 counter. n_pairs is a multiple of 1024.
extern "C" int lane_bottom(const void* sid_blocks, const void* sub,
                           int sub_stride, const void* ro, const void* rd,
                           const void* tmax, const void* active, void* t_out,
                           void* tri_out, void* capped, int n_pairs,
                           int max_steps, int any_hit, void* stream) {
  if (n_pairs <= 0) return 0;
  if (n_pairs % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_pairs / kBottomThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sid = static_cast<const int32_t*>(sid_blocks);
  auto* tab = static_cast<const float*>(sub);
  auto* o = static_cast<const float*>(ro);
  auto* d = static_cast<const float*>(rd);
  auto* tm = static_cast<const float*>(tmax);
  auto* act = static_cast<const int32_t*>(active);
  auto* t = static_cast<float*>(t_out);
  auto* tri = static_cast<int32_t*>(tri_out);
  auto* cap = static_cast<int32_t*>(capped);
  if (any_hit) {
    lane_bottom_kernel<true><<<grid, kBottomThreads, 0, s>>>(
        sid, tab, sub_stride, o, d, tm, act, t, tri, cap, max_steps);
  } else {
    lane_bottom_kernel<false><<<grid, kBottomThreads, 0, s>>>(
        sid, tab, sub_stride, o, d, tm, act, t, tri, cap, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
