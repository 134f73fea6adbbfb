// E6 and E7: the two per-lane walks of the treelet traversal.
//
// E6 replaces the TPU kernel experiments/treelet/lane_top.py::
// _lane_top_kernel (launched by _lane_top_trace, wrapped by
// lane_top_trace): each ray walks the threaded top of the BVH2 and
// collects up to 8 ids of the subtrees whose root boxes it enters.
// E7 replaces experiments/treelet/lane_bottom.py::_lane_bottom_kernel
// (wrapped by lane_bottom_trace): each (ray, subtree) pair walks its
// subtree, node boxes and triangles, to (t, tri_local); closest-hit or
// any-hit. It has two epilogues: per pair (that contract: t, tri_local at
// each pair slot) and per ray (lane_bottom.py::lane_bottom_rays, what the
// pipeline runs): the combine of experiments/treelet/pipeline.py
// (least t over a ray's pairs, then the largest global triangle id) done
// by one 64-bit atomicMin per accepted pair. The plain twins are
// loupiote_tpu_torch/treelet/lane_top.py::lane_top_plain and
// lane_bottom.py::lane_bottom_plain / lane_bottom_rays_plain; kernel and
// twin take the same steps with the same arithmetic, so they agree bit for
// bit (the atomics' order cannot change a minimum).
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
// E7 walks a subtree (10 fields x 1,024 entries) staged in shared memory,
// the counterpart of the TPU kernel's scalar-prefetched VMEM tile. The
// pair layout (treelet/regroup.py::block_regroup) puts each subtree's
// pairs in a run of consecutive 1,024-pair tiles, so a block walks runs
// of tiles, stages a subtree only when the tile's subtree changes, and
// copies the next one in (cp.async, two buffers) while it walks.
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
constexpr int kPairsPerThread = kTile / kBottomThreads;
constexpr int kChunkTiles = 2;   // consecutive tiles a block takes at once
constexpr int kSubFloats = kWalkFields * kTile;  // a staged subtree
constexpr float kTMin = 1e-4f;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

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

// Stage subtree `tile` (its 10 walked fields, 1,024 floats each, every
// field sub_stride floats from the last) into buf[10][1024] with 16-byte
// async copies.
__device__ __forceinline__ void stage(float* buf, const float* tile,
                                      int sub_stride) {
  constexpr int kQuads = kTile / 4;
  for (int e = threadIdx.x; e < kWalkFields * kQuads; e += blockDim.x) {
    const int f = e / kQuads, q = e % kQuads;
    cp_async16(buf + f * kTile + 4 * q,
               tile + static_cast<size_t>(f) * sub_stride + 4 * q);
  }
}

// One pair's walk of the staged subtree (the reference kernel's steps and
// arithmetic): a node entry's slab test against the pair's best t goes
// to hit_id or miss_id; a triangle entry runs Moller-Trumbore. Returns
// tri_local (-1 on a miss); best holds the pair's t.
template <bool kAnyHit>
__device__ __forceinline__ int walk(const float* f, float ox, float oy,
                                    float oz, float dx, float dy, float dz,
                                    float& best, int32_t* capped,
                                    int max_steps) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int best_tri = -1;
  int cur = 0;
  for (int steps = 0; cur != kSubEnd; ++steps) {
    if (steps == max_steps) {  // the reference's silent step bound
      atomicAdd(capped, 1);
      break;
    }
    const int link = __float_as_int(f[9 * kTile + cur]);
    const int hit_id = link & 1023;
    const int miss_id = (link >> 10) & 1023;
    if ((link >> 20) & 1) {
      // Moller-Trumbore, products in the order of ops/intersect.py.
      const float p0x = f[cur], p0y = f[kTile + cur], p0z = f[2 * kTile + cur];
      const float e1x = f[3 * kTile + cur], e1y = f[4 * kTile + cur],
                  e1z = f[5 * kTile + cur];
      const float e2x = f[6 * kTile + cur], e2y = f[7 * kTile + cur],
                  e2z = f[8 * kTile + cur];
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
      if (fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
          t > kTMin && t < best) {
        best = t;
        best_tri = (link >> 21) & 1023;
        if (kAnyHit) break;  // the first accepted triangle ends the walk
      }
      cur = miss_id;  // a triangle entry holds its next id in both slots
    } else {
      float tn, tf;
      slab(f[cur], f[kTile + cur], f[2 * kTile + cur], f[3 * kTile + cur],
           f[4 * kTile + cur], f[5 * kTile + cur], ox, oy, oz, ix, iy, iz,
           &tn, &tf);
      cur = (tf >= fmaxf(tn, 0.0f) && tn < best) ? hit_id : miss_id;
    }
  }
  return best_tri;
}

// E7 with either epilogue. Each block walks the tiles of its chunks
// (blockIdx.x, blockIdx.x + gridDim.x, ...; a chunk is kChunkTiles
// consecutive tiles of 1,024 pairs) in order, two pairs a thread. It
// stages a tile's subtree only when the block does not hold it already
// (block_regroup lays out each subtree's pairs as a run of tiles),
// skips tiles with no live pair and the dump tiles (sid >= n_sub; their
// walks would end at the first entry), and copies the next tile's
// subtree into the other buffer (cp.async) while it walks this one.
// kPerRay == false: pair p walks ray data at p and writes (t, tri_local)
// at p. kPerRay == true: pair p walks ray pair_ray[p] and an accepted
// hit does atomicMin(hit_out[ray], float_bits(t) << 32 | 0x7FFFFFFF -
// global tri): the least t, then the largest global id (t > T_MIN > 0,
// so the bits order as the values).
template <bool kAnyHit, bool kPerRay>
__global__ void __launch_bounds__(kBottomThreads, 2)
    lane_bottom_kernel(const int32_t* __restrict__ sid_blocks, int n_tiles,
                       int n_sub, const float* __restrict__ sub,
                       int sub_stride, const int32_t* __restrict__ pair_ray,
                       const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ tmax,
                       const int32_t* __restrict__ active,
                       const int32_t* __restrict__ tri_base,
                       float* __restrict__ t_out,
                       int32_t* __restrict__ tri_out,
                       unsigned long long* __restrict__ hit_out,
                       int32_t* __restrict__ capped, int max_steps) {
  extern __shared__ float4 smem4[];  // two subtree buffers
  float* const smem = reinterpret_cast<float*>(smem4);
  int cb = 1;        // the buffer the last walked tile read
  int hc = -1;       // the subtree in (or on its way to) buffer cb
  int ho = -1;       // and in buffer cb ^ 1
  int k = blockIdx.x * kChunkTiles;
  while (k < n_tiles) {
    int nk = k + 1;  // this block's next tile
    if (nk % kChunkTiles == 0) nk += (gridDim.x - 1) * kChunkTiles;
    const int sid = sid_blocks[k];
    bool on[kPairsPerThread];
    bool any = false;
#pragma unroll
    for (int h = 0; h < kPairsPerThread; ++h) {
      on[h] = active[k * kTile + h * kBottomThreads + threadIdx.x] > 0;
      any |= on[h];
    }
    // Also the barrier after the last tile's reads of its buffer.
    any = __syncthreads_or(any) && sid < n_sub;
    if (any) {
      const bool swap = hc != sid;
      if (swap) {  // walk from the other buffer
        cb ^= 1;
        const int h = hc;
        hc = ho;
        ho = h;
        if (hc != sid) {
          cp_async_wait<0>();  // a copy ahead for a tile that was skipped
          stage(smem + cb * kSubFloats,
                sub + static_cast<size_t>(sid) * kTile, sub_stride);
          cp_async_commit();
          hc = sid;
        }
      }
      const int nsid = nk < n_tiles ? sid_blocks[nk] : n_sub;
      if (nsid < n_sub && nsid != sid && ho != nsid) {
        // Buffer cb ^ 1 was last read before the barrier above. Without a
        // swap, a copy ahead for a tile that was skipped may still be
        // landing in it: cp.async orders no writes between groups, so
        // let it finish first (this tile's buffer is complete already).
        if (!swap) cp_async_wait<0>();
        stage(smem + (cb ^ 1) * kSubFloats,
              sub + static_cast<size_t>(nsid) * kTile, sub_stride);
        cp_async_commit();
        ho = nsid;
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float* buf = smem + cb * kSubFloats;
    const int base = kPerRay && any ? tri_base[sid] : 0;
#pragma unroll
    for (int h = 0; h < kPairsPerThread; ++h) {
      const int p = k * kTile + h * kBottomThreads + threadIdx.x;
      const int r = kPerRay ? (on[h] && any ? pair_ray[p] : 0) : p;
      float best = 0.0f;
      int tri = -1;
      if (!kPerRay || (on[h] && any)) best = tmax[r];
      if (on[h] && any) {
        tri = walk<kAnyHit>(buf, ro[3 * r], ro[3 * r + 1], ro[3 * r + 2],
                            rd[3 * r], rd[3 * r + 1], rd[3 * r + 2], best,
                            capped, max_steps);
      }
      if (!kPerRay) {
        t_out[p] = best;
        tri_out[p] = tri;
      } else if (tri >= 0) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(best)) << 32) |
            static_cast<unsigned>(0x7FFFFFFF - (base + tri));
        atomicMin(hit_out + r, key);
      }
    }
    k = nk;
  }
  cp_async_wait<0>();  // a copy ahead of a tile that was skipped
}

template <bool kAnyHit, bool kPerRay>
int launch_bottom(const int32_t* sid, int n_tiles, int n_sub,
                  const float* sub, int sub_stride, const int32_t* pair_ray,
                  const float* ro, const float* rd, const float* tmax,
                  const int32_t* active, const int32_t* tri_base, float* t,
                  int32_t* tri, unsigned long long* hit, int32_t* capped,
                  int max_steps, cudaStream_t s) {
  auto kernel = lane_bottom_kernel<kAnyHit, kPerRay>;
  const int smem = 2 * kSubFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kBottomThreads, smem);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_chunks = (n_tiles + kChunkTiles - 1) / kChunkTiles;
  const int blocks = n_chunks < sms * per_sm ? n_chunks : sms * per_sm;
  kernel<<<blocks, kBottomThreads, smem, s>>>(
      sid, n_tiles, n_sub, sub, sub_stride, pair_ray, ro, rd, tmax, active,
      tri_base, t, tri, hit, capped, max_steps);
  return static_cast<int>(cudaGetLastError());
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

// sid_blocks (n_tiles,) i32, the subtree of each 1,024-pair tile (>=
// n_sub: a dump tile); sub: (11, sub_stride) f32 with sub_stride =
// (n_sub + 1) * 1024, 16-byte aligned; active (n_tiles * 1024,) i32;
// capped: one i32 counter.
// Per pair (per_ray == 0): ro, rd (n_pairs, 3) f32 and tmax (n_pairs,)
// f32 at the pair slots; writes t (n_pairs,) f32, tri (n_pairs,) i32
// (tri_local, -1 on a miss); pair_ray, tri_base, hit unused.
// Per ray (per_ray != 0): pair_ray (n_pairs,) i32; ro, rd (R, 3) f32 and
// tmax (R,) f32 by ray; tri_base (n_sub + 1,) i32; hit (R,) u64, set to
// 2^63 - 1 (no hit) before the launch; t, tri unused.
extern "C" int lane_bottom(const void* sid_blocks, int n_tiles, int n_sub,
                           const void* sub, int sub_stride,
                           const void* pair_ray, const void* ro,
                           const void* rd, const void* tmax,
                           const void* active, const void* tri_base,
                           void* t_out, void* tri_out, void* hit,
                           void* capped, int max_steps, int any_hit,
                           int per_ray, void* stream) {
  if (n_tiles <= 0) return 0;
  auto* sid = static_cast<const int32_t*>(sid_blocks);
  auto* tab = static_cast<const float*>(sub);
  auto* pr = static_cast<const int32_t*>(pair_ray);
  auto* o = static_cast<const float*>(ro);
  auto* d = static_cast<const float*>(rd);
  auto* tm = static_cast<const float*>(tmax);
  auto* act = static_cast<const int32_t*>(active);
  auto* base = static_cast<const int32_t*>(tri_base);
  auto* t = static_cast<float*>(t_out);
  auto* tri = static_cast<int32_t*>(tri_out);
  auto* h = static_cast<unsigned long long*>(hit);
  auto* cap = static_cast<int32_t*>(capped);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = any_hit ? (per_ray ? launch_bottom<true, true>
                                : launch_bottom<true, false>)
                     : (per_ray ? launch_bottom<false, true>
                                : launch_bottom<false, false>);
  return fn(sid, n_tiles, n_sub, tab, sub_stride, pr, o, d, tm, act, base, t,
            tri, h, cap, max_steps, s);
}
