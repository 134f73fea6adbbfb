// E6 and E7: the two per-lane walks of the treelet traversal.
//
// E6 replaces the TPU kernel experiments/treelet/lane_top.py::
// _lane_top_kernel (launched by _lane_top_trace, wrapped by
// lane_top_trace): each ray walks the threaded top of the BVH2 and
// collects up to 8 ids of the subtrees whose root boxes it enters. It has
// two epilogues: per ray (that contract: pend, npend) and compacting
// (lane_top.py::lane_top_pairs, what the pipeline runs): the (subtree,
// ray) pairs laid out in PAIR_BUDGET * R slots by an exclusive scan of
// the pending counts over the rays, with the rays that fall back flagged,
// which is loupiote_tpu_torch/treelet/lane_top.py::compact_pairs.
// E7 replaces experiments/treelet/lane_bottom.py::_lane_bottom_kernel
// (wrapped by lane_bottom_trace): each (ray, subtree) pair walks its
// subtree, node boxes and triangles, to (t, tri_local); closest-hit or
// any-hit. It has two epilogues: per pair (that contract: t, tri_local at
// each pair slot) and per ray (lane_bottom.py::lane_bottom_rays, what the
// pipeline runs): the combine of experiments/treelet/pipeline.py
// (least t over a ray's pairs, then the largest global triangle id) done
// by one 64-bit atomicMin per accepted pair. The plain twins are
// loupiote_tpu_torch/treelet/lane_top.py::lane_top_plain (with
// compact_pairs for the compacting epilogue) and
// lane_bottom.py::lane_bottom_plain / lane_bottom_rays_plain; kernel and
// twin take the same steps with the same arithmetic, so they agree bit for
// bit (the atomics' order cannot change a minimum, and the scan's sums
// are exact).
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
// latency and divergence, not bytes or flops.
// E6: the top table is small (32 KB for arch-260k; at most 8 x 4,096
// entries = 128 KB), so a persistent grid of blocks, as many as fit the
// SMs, stages it into shared memory once a block, entry-major (two
// 16-byte words an entry, one pair of loads a step), and walks tiles of
// 256 rays from there. A ray's pending ids stay in registers and leave as
// two 16-byte stores (per ray), or go straight to their pair slots
// (compacting). The compacting epilogue is a single-pass ordered scan
// (decoupled look-back): blocks take ray tiles from a ticket in ray
// order, publish each tile's pair count, and the first warp of the block
// sums its predecessors' counts, stopping at the first tile that has
// published its inclusive prefix; so a tile waits only on tiles that are
// already running. Each pair slot is written once: a ray's slots by its
// tile, the slots past the last pair by every block once the last tile's
// prefix is known.
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

#include "nan_minmax.cuh"

namespace {

constexpr int kPendCap = 8;      // treelet/build.py: PEND_CAP
constexpr int kTopIdBits = 12;   // treelet/build.py: TOP_ID_BITS
constexpr int kIdMask = (1 << kTopIdBits) - 1;
constexpr int kSubEnd = 1023;    // treelet/build.py: SUB_END
constexpr int kTile = 1024;      // entries per subtree; pairs per block
constexpr int kWalkFields = 10;  // f0..f9
constexpr int kTopThreads = 256;  // treelet/lane_top.py: TILE_RAYS
constexpr int kBottomThreads = 512;
constexpr int kPairsPerThread = kTile / kBottomThreads;
constexpr int kChunkTiles = 2;   // consecutive tiles a block takes at once
constexpr int kSubFloats = kWalkFields * kTile;  // a staged subtree
constexpr float kTMin = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

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
  *tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                min_nan(t1z, t2z));
  *tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                max_nan(t1z, t2z));
}

// Stage the top table (8 fields of top_stride floats) into shared memory
// entry-major: entry e is tab4[2e] = min.xyz, max.x and tab4[2e + 1] =
// max.yz, link, pend.
__device__ __forceinline__ void stage_top(float4* tab4, const float* top,
                                          int top_stride) {
  for (int e = threadIdx.x; e < top_stride; e += kTopThreads) {
    float v[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) v[f] = __ldg(top + f * top_stride + e);
    tab4[2 * e] = make_float4(v[0], v[1], v[2], v[3]);
    tab4[2 * e + 1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
}

// Ray i's walk of the staged top table (the reference kernel's steps and
// arithmetic). Returns npend; p holds the ids, -1 past npend.
__device__ __forceinline__ int top_walk(const float4* tab4, const float* ro,
                                        const float* rd, const float* tmax,
                                        int i, int (&p)[kPendCap],
                                        int32_t* capped, int max_steps) {
#pragma unroll
  for (int k = 0; k < kPendCap; ++k) p[k] = -1;
  const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
  const float ix = safe_inv(rd[3 * i]), iy = safe_inv(rd[3 * i + 1]),
              iz = safe_inv(rd[3 * i + 2]);
  const float t0 = tmax[i];
  int np = 0;
  int cur = 0;
  for (int steps = 0; cur != kIdMask; ++steps) {
    if (steps == max_steps) {  // the reference's silent step bound
      atomicAdd(capped, 1);
      break;
    }
    const float4 a = tab4[2 * cur], b = tab4[2 * cur + 1];
    float tn, tf;
    slab(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy, oz, ix, iy, iz, &tn, &tf);
    const int link = __float_as_int(b.z);
    const int pe = __float_as_int(b.w);
    const bool hit = tf >= max_nan(tn, 0.0f) && tn < t0;
    const int hit_id = link & kIdMask;
    const int miss_id = (link >> kTopIdBits) & kIdMask;
    if (hit && pe >= 0) {
      if (np >= kPendCap) {  // all slots full: park the lane at END
        cur = kIdMask;
        continue;
      }
#pragma unroll
      for (int k = 0; k < kPendCap; ++k) {  // p[np] = pe, in registers
        if (k == np) p[k] = pe;
      }
      ++np;
    }
    cur = (hit && hit_id != kIdMask) ? hit_id : miss_id;
  }
  return np;
}

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// A tile's scan word: flag << 32 | count. Flag 1: the tile's own pair
// count; flag 2: the pairs of every ray up to and including the tile.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The pairs of the tiles before `tile` (warp 0 of the block, all lanes):
// publish the tile's own count, read the 32 tiles before it at once
// (waiting where one has published nothing yet), add counts back to the
// nearest tile with a prefix, then publish this tile's prefix.
__device__ __forceinline__ unsigned look_back(unsigned long long* state,
                                              int tile, unsigned agg,
                                              int lane) {
  if (tile == 0) {
    if (lane == 0) atomicExch(state, kPrefix | agg);
    return 0;
  }
  if (lane == 0) atomicExch(state + tile, kAggregate | agg);
  unsigned excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;
    unsigned long long s = kPrefix;  // before tile 0: a prefix of 0
    if (idx >= 0) {
      do {
        s = load_state(state + idx);
      } while ((s >> 32) == 0);
    }
    const unsigned pm = __ballot_sync(kFull, (s >> 32) == 2);
    const int first = pm ? __ffs(pm) - 1 : 31;  // the nearest prefix
    unsigned v = lane <= first ? static_cast<unsigned>(s) : 0u;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (pm) break;
  }
  if (lane == 0) atomicExch(state + tile, kPrefix | (excl + agg));
  return excl;
}

// E6 with either epilogue; a persistent grid, each block stages the top
// table once.
// kCompact == false: ray tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// writes pend (two 16-byte stores a ray) and npend.
// kCompact == true: ray tiles from the ticket state[n_tiles], in order;
// state[t] is tile t's scan word (zero before the launch). A ray with
// n = npend pairs (0 if inactive) owns slots [base, base + n) of the
// exclusive scan; it falls back if active and base + n > p_pad or
// n == kPendCap, and then writes the dump key n_sub and ray 0 to its
// slots below p_pad; else its pairs (id, ray). Slots from the total on get
// the dump key and ray 0.
template <bool kCompact>
__global__ void __launch_bounds__(kTopThreads)
    lane_top_kernel(const float* __restrict__ top, int top_stride,
                    const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ tmax,
                    const uint8_t* __restrict__ active,
                    int32_t* __restrict__ pend_out,
                    int32_t* __restrict__ npend_out,
                    int32_t* __restrict__ key_out,
                    int32_t* __restrict__ ray_out,
                    uint8_t* __restrict__ fb_out,
                    unsigned long long* __restrict__ state,
                    int32_t* __restrict__ capped, int n_rays, int max_steps,
                    int n_sub, int p_pad) {
  extern __shared__ float4 tab4[];
  stage_top(tab4, top, top_stride);
  const int n_tiles = (n_rays + kTopThreads - 1) / kTopThreads;
  if (!kCompact) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int i = tile * kTopThreads + threadIdx.x;
      if (i >= n_rays) break;
      int p[kPendCap];
      int np = 0;
      if (active[i]) {
        np = top_walk(tab4, ro, rd, tmax, i, p, capped, max_steps);
      } else {
#pragma unroll
        for (int k = 0; k < kPendCap; ++k) p[k] = -1;
      }
      int4* o = reinterpret_cast<int4*>(pend_out) + 2 * static_cast<size_t>(i);
      o[0] = make_int4(p[0], p[1], p[2], p[3]);
      o[1] = make_int4(p[4], p[5], p[6], p[7]);
      npend_out[i] = np;
    }
    return;
  }
  constexpr int kWarps = kTopThreads / 32;
  __shared__ int s_tile;
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned pad = static_cast<unsigned>(p_pad);
  for (;;) {
    if (threadIdx.x == 0) {
      s_tile = static_cast<int>(atomicAdd(state + n_tiles, 1ull));
    }
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) break;
    const int i = tile * kTopThreads + threadIdx.x;
    const bool act = i < n_rays && active[i];
    int p[kPendCap];
    int np = 0;
    if (act) np = top_walk(tab4, ro, rd, tmax, i, p, capped, max_steps);
    // The block's exclusive scan of np: within warps, then of the warps.
    unsigned x = np;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned w = lane < kWarps ? s_warp[lane] : 0u;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) s_warp[lane] = w;
      const unsigned agg = __shfl_sync(kFull, w, kWarps - 1);
      const unsigned excl = look_back(state, tile, agg, lane);
      if (lane == 0) s_excl = excl;
    }
    __syncthreads();
    const unsigned base = s_excl + (warp ? s_warp[warp - 1] : 0u) + x -
                          static_cast<unsigned>(np);
    // npend == kPendCap may be an incomplete walk: such rays fall back,
    // as do rays past the budget.
    const bool fb =
        act && (base + static_cast<unsigned>(np) > pad || np >= kPendCap);
#pragma unroll
    for (int k = 0; k < kPendCap; ++k) {
      if (k < np && base + k < pad) {
        key_out[base + k] = fb ? n_sub : p[k];
        ray_out[base + k] = fb ? 0 : i;
      }
    }
    if (i < n_rays) fb_out[i] = fb;
  }
  // The slots past the last pair, once the last tile's prefix is known
  // (every tile has been taken by a running block, so it will be).
  __shared__ unsigned s_total;
  if (threadIdx.x == 0) {
    unsigned long long s;
    do {
      s = load_state(state + n_tiles - 1);
    } while ((s >> 32) != 2);
    s_total = static_cast<unsigned>(s);
  }
  __syncthreads();
  for (unsigned slot = s_total + blockIdx.x * kTopThreads + threadIdx.x;
       slot < pad; slot += gridDim.x * kTopThreads) {
    key_out[slot] = n_sub;
    ray_out[slot] = 0;
  }
}

// The persistent grid of lane_top_kernel<kCompact>: as many blocks as fit
// the SMs beside the staged table, at most one a tile. Returns the block
// count, or minus a CUDA error.
template <bool kCompact>
int top_grid(int top_stride, int n_rays) {
  auto kernel = lane_top_kernel<kCompact>;
  const int smem = top_stride * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTopThreads, smem)) != cudaSuccess)
    return -static_cast<int>(err);
  if (sms < 1 || per_sm < 1)
    return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_rays + kTopThreads - 1) / kTopThreads;
  return n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
}

template <bool kCompact>
int launch_top(const float* top, int top_stride, const float* ro,
               const float* rd, const float* tmax, const uint8_t* active,
               int32_t* pend, int32_t* npend, int32_t* key, int32_t* ray,
               uint8_t* fb, unsigned long long* state, int32_t* capped,
               int n_rays, int max_steps, int n_sub, int p_pad,
               cudaStream_t s) {
  const int blocks = top_grid<kCompact>(top_stride, n_rays);
  if (blocks < 1)
    return blocks == 0 ? static_cast<int>(cudaErrorInvalidConfiguration)
                       : -blocks;
  lane_top_kernel<kCompact><<<blocks, kTopThreads, top_stride * 32, s>>>(
      top, top_stride, ro, rd, tmax, active, pend, npend, key, ray, fb, state,
      capped, n_rays, max_steps, n_sub, p_pad);
  return static_cast<int>(cudaGetLastError());
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
      cur = (tf >= max_nan(tn, 0.0f) && tn < best) ? hit_id : miss_id;
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

// top: (8, top_stride) f32, top_stride a multiple of 1,024 and at most
// 4,096; ro, rd (n, 3) f32; tmax (n,) f32; active (n,) bool; capped: one
// i32 counter.
// lane_top (per ray): pend (n, 8) i32, 16-byte aligned; npend (n,) i32.
extern "C" int lane_top(const void* top, int top_stride, const void* ro,
                        const void* rd, const void* tmax, const void* active,
                        void* pend, void* npend, void* capped, int n_rays,
                        int max_steps, void* stream) {
  if (n_rays <= 0) return 0;
  return launch_top<false>(
      static_cast<const float*>(top), top_stride,
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(tmax), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(pend), static_cast<int32_t*>(npend), nullptr,
      nullptr, nullptr, nullptr, static_cast<int32_t*>(capped), n_rays,
      max_steps, 0, 0, static_cast<cudaStream_t>(stream));
}

// lane_top_pairs (compacting): key, ray_of (p_pad,) i32; fallback (n,)
// bool; state (ceil(n / 256) + 1,) u64, zero: a scan word a tile of 256
// rays, then the tile ticket; n_sub: the dump key; 8 * n < 2^31.
extern "C" int lane_top_pairs(const void* top, int top_stride,
                              const void* ro, const void* rd,
                              const void* tmax, const void* active,
                              void* key, void* ray_of, void* fallback,
                              void* state, void* capped, int n_rays,
                              int max_steps, int n_sub, int p_pad,
                              void* stream) {
  if (n_rays <= 0) return 0;
  return launch_top<true>(
      static_cast<const float*>(top), top_stride,
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(tmax), static_cast<const uint8_t*>(active),
      nullptr, nullptr, static_cast<int32_t*>(key),
      static_cast<int32_t*>(ray_of), static_cast<uint8_t*>(fallback),
      static_cast<unsigned long long*>(state), static_cast<int32_t*>(capped),
      n_rays, max_steps, n_sub, p_pad, static_cast<cudaStream_t>(stream));
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
