// E1: sub-packet traversal of the wide table, the step-cost probe in its
// five variants (full, nomt, noorder, nostack, nofetch).
//
// Replaces the TPU kernel experiments/kernel_probe.py::probe_kernel
// (launched by probe_trace). Each 128-ray row of the reference's (8, 128)
// block is one sub-packet: its lanes share one node cursor and one stack,
// and each lane keeps its own best t, u, v, tri. At an internal row,
// child c is taken if any live lane's slab test hits it with tn < t_lane;
// its packet distance is the minimum tn over those lanes; the rank of a
// hit child is the count of hit children nearer by (distance, index)
// (noorder: by index only). The nearest child is descended and the others
// are pushed farthest-first at ptr + nchild - 1 - rank; a leaf row, or a
// row with no hit child, pops. A push at or beyond stack_size is dropped
// (the reference's one-hot scatter writes nowhere) and counted; a pop
// from beyond the stack reads 0. The plain torch twin is
// loupiote_tpu_torch/experiments/kernel_probe.py::probe_trace_plain; both
// follow the same arithmetic, so the card's check is bit equality.
//
// One difference from the reference, on purpose: a child pointer to a
// leaf row carries the LEAF_TAG bit 1 << 30 in today's wide table, and
// the reference probe (older than the tag) followed the raw pointer past
// the table's end, so every packet retired at its first leaf child. The
// port masks the tag off every non-negative pointer (-1 marks an empty
// slot and is left alone), so the full probe returns the closest hits.
// The row's kind still comes from float 127.
//
// Design: one warp walks one packet at a time, with no block barrier, on a
// persistent grid whose warps take packets from a counter. Lane l holds
// rays l, 32 + l, 64 + l and 96 + l; the warp keeps the packet's row (one
// float4 a lane, staged in its own slice of shared memory), stack, cursor
// and stack pointer, every lane alike. At an internal row:
// - a child with a negative pointer (an empty slot) is not tested: the
//   hit mask excludes it whatever its box gives;
// - where every active ray of the packet has finite origin components and
//   one sign of each inverse direction component (the sorted wave is
//   octant-major), and a child's box has min <= max on each axis, the
//   slab test takes the packet's near and far planes: for ix > 0,
//   (b0 - ox) * ix <= (b3 - ox) * ix because rounding is monotone, so
//   min and max of the pair are the near and the far term (equal values;
//   a zero's sign may differ, which only < and == read). That saves six
//   min/max of each ray's box test, and a row whose valid children all
//   qualify runs its eight children unrolled (one helper, child_key,
//   tests a child either way);
// - each lane takes the fminf of its rays' hit distances and the warp the
//   minimum of one order-preserving key a lane (redux.sync): unsigned
//   order is float order, -0 read as +0, so ranks and hits are the twin's;
// - lane c ranks child c against the others' keys (shuffles), a ballot of
//   the lanes with rank 0 names the nearest child, the lanes of the others
//   push them, and a ballot counts the pushes past the stack.
// A leaf row's triangles are tested by every lane for its four rays.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W, SM clock 1,980
// MHz under this kernel; PERF.md, E1): instruction issue, and the wave's
// tail. A leaf step issues ~65 instructions a ray and triangle (the
// twin's unfused products and adds, --fmad=false, and the reciprocal),
// an internal step ~22 a ray and child plus ~15 a child for the warp;
// the row loads hide behind the other warps. The redesign took out the
// parent's per-step overheads (shuffle trees, thread 0's serial ranking,
// three barriers) and, on coherent packets (99.97% of the sorted wave's
// box tests), six of the eleven min/max of each box test; without the
// unrolled row the loop read 3% slower on full, 5% on nomt and 15% on
// nofetch. The leaf tests are the twin's own arithmetic. Packets
// take 2-3x the mean on the long end, so the last ~15% of a call runs
// with fewer than half the packets resident. The persistent grid, whose
// warps take the next packet as soon as theirs ends, gained ~3% over a
// block of four packets; fewer resident packets and several warps a
// packet lost (the sweep in PERF.md).
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // rays a packet
constexpr int kRays = 4;     // rays a lane
constexpr int kPackets = 4;  // warps a block, each walking its own packets
constexpr int kBlocksPerSm = 5;
constexpr int kWidth = 8;
constexpr int kLeafTag = 1 << 30;
constexpr int kLeafMask = kLeafTag - 1;
constexpr float kBig = 3e30f;
constexpr float kTMin = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStack = 2048;

enum Probe { kFullProbe = 0, kNoMt = 1, kNoOrder = 2, kNoStack = 3, kNoFetch = 4 };

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

// Unsigned order of the key = float order of a non-NaN distance, with -0
// read as +0 (the ranking compares distances with < and ==, where the two
// zeros are equal).
__device__ __forceinline__ unsigned dist_key(float f) {
  unsigned b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t, u, v;
  int tri;
  bool a;
};

// Moller-Trumbore as the twin writes it, on a triangle in shared memory.
__device__ __forceinline__ void tri_test(Ray& r, const float* tr, int id) {
  const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
  const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
  const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
  const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (r.a && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
      tt < r.t) {
    r.t = tt;
    r.u = uu;
    r.v = vv;
    r.tri = id;
  }
}

// m = min(m, tn) where ray y hits the box nearer than its best t. tn and
// tf from the packet's near planes (nx, ny, nz) and far planes.
__device__ __forceinline__ void box_planes(const Ray& y, float nx, float ny,
                                           float nz, float fx, float fy,
                                           float fz, float& m) {
  const float tn = fmaxf(fmaxf((nx - y.ox) * y.ix, (ny - y.oy) * y.iy),
                         (nz - y.oz) * y.iz);
  const float tf = fminf(fminf((fx - y.ox) * y.ix, (fy - y.oy) * y.iy),
                         (fz - y.oz) * y.iz);
  if (y.a && tf >= fmaxf(tn, 0.0f) && tn < y.t) m = fminf(m, tn);
}

// The same from both slabs of box b, as the twin writes it.
__device__ __forceinline__ void box_slabs(const Ray& y, const float* b,
                                          float& m) {
  const float t1x = (b[0] - y.ox) * y.ix, t2x = (b[3] - y.ox) * y.ix;
  const float t1y = (b[1] - y.oy) * y.iy, t2y = (b[4] - y.oy) * y.iy;
  const float t1z = (b[2] - y.oz) * y.iz, t2z = (b[5] - y.oz) * y.iz;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                         fminf(t1z, t2z));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                         fmaxf(t1z, t2z));
  if (y.a && tf >= fmaxf(tn, 0.0f) && tn < y.t) m = fminf(m, tn);
}

// The packet's key of one child: each lane's fminf of its rays' hit
// distances to box b, by the packet's planes (`off`: the near plane's
// offset on each axis) where `planes`, else by both slabs; then the warp's
// minimum key.
__device__ __forceinline__ unsigned child_key(const Ray* r, const float* b,
                                              const int* off, bool planes) {
  float m = kBig;
  if (planes) {
    const float nx = b[off[0]], ny = b[1 + off[1]], nz = b[2 + off[2]];
    const float fx = b[3 - off[0]], fy = b[4 - off[1]], fz = b[5 - off[2]];
#pragma unroll
    for (int j = 0; j < kRays; ++j) box_planes(r[j], nx, ny, nz, fx, fy, fz, m);
  } else {
#pragma unroll
    for (int j = 0; j < kRays; ++j) box_slabs(r[j], b, m);
  }
  return __reduce_min_sync(kFull, dist_key(m));
}

// One packet's traversal state, the same in every lane of its warp.
struct Walk {
  int cur, ptr, done, n_dropped;
};

// Rank the hit children on lanes 0-7 (lane c: child c; lanes 8-31 repeat
// them), push all but the nearest, and return the number of hit children;
// `near` gets the nearest one's pointer. `kc`: this lane's child's packet
// key; `cp`: its raw pointer.
template <int kProbe>
__device__ __forceinline__ int rank_and_push(unsigned kc, int cp, int lane,
                                             Walk& w, int* stack,
                                             int stack_size, int& near) {
  const int c = lane & 7;
  const bool h = kc < dist_key(kBig) && cp >= 0;
  const unsigned hit = __ballot_sync(kFull, h) & 0xffu;
  const int nchild = __popc(hit);
  int r = 0;
  if (kProbe == kNoOrder) {
    r = __popc(hit & ((1u << c) - 1u));
  } else {
#pragma unroll
    for (int q = 0; q < kWidth; ++q) {
      const unsigned kq = __shfl_sync(kFull, kc, q);
      r += ((hit >> q) & 1u) && (kq < kc || (kq == kc && q < c));
    }
  }
  const int pc = cp >= 0 ? (cp & kLeafMask) : cp;
  const unsigned first = __ballot_sync(kFull, h && r == 0) & 0xffu;
  near = __shfl_sync(kFull, pc, first ? __ffs(first) - 1 : 0);
  if (kProbe != kNoStack) {
    const int pos = w.ptr + nchild - 1 - r;
    const bool push = lane < kWidth && h && r >= 1;
    if (push && pos < stack_size) stack[pos] = pc;
    w.n_dropped += __popc(__ballot_sync(kFull, push && pos >= stack_size));
  }
  return nchild;
}

// Descend to the nearest hit child, else pop (as the twin does).
template <int kProbe>
__device__ __forceinline__ void advance(Walk& w, int nchild, int near,
                                        const int* stack, int stack_size,
                                        int end_index) {
  const bool descend = nchild > 0;
  const int pos = kProbe != kNoStack && descend ? w.ptr + nchild - 1 : w.ptr;
  const int top = pos - 1 > 0 ? pos - 1 : 0;
  const int popped = top < stack_size ? stack[top] : 0;
  const int nxt = descend ? near : (pos > 0 ? popped : end_index);
  w.ptr = descend ? pos : top;
  const bool fin = nxt >= end_index;
  w.cur = fin ? 0 : nxt;
  w.done = fin;
}

// Packet p, walked by one warp; `s_row` and `stack` are the warp's.
template <int kProbe>
__device__ __forceinline__ void walk_packet(
    int p, int lane, float* s_row, int* stack, const float* __restrict__ rows,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ t0_, const int32_t* __restrict__ act_,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int32_t* __restrict__ tri_out,
    int32_t* __restrict__ steps_out, int32_t* __restrict__ dropped,
    int end_index, int max_steps, int leaf_cap, int stack_size) {
  Ray r[kRays];
  bool any = false, finite = true;
  bool neg[3] = {false, false, false}, pos[3] = {false, false, false};
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t i = static_cast<size_t>(p) * kLanes + 32 * k + lane;
    Ray& y = r[k];
    y.ox = ox_[i];
    y.oy = oy_[i];
    y.oz = oz_[i];
    y.dx = dx_[i];
    y.dy = dy_[i];
    y.dz = dz_[i];
    y.ix = safe_inv(y.dx);
    y.iy = safe_inv(y.dy);
    y.iz = safe_inv(y.dz);
    y.t = t0_[i];
    y.u = 0.0f;
    y.v = 0.0f;
    y.tri = -1;
    y.a = act_[i] != 0;
    if (y.a) {
      any = true;
      finite &= isfinite(y.ox) && isfinite(y.oy) && isfinite(y.oz);
      neg[0] |= y.ix < 0.0f;
      neg[1] |= y.iy < 0.0f;
      neg[2] |= y.iz < 0.0f;
      pos[0] |= y.ix > 0.0f;
      pos[1] |= y.iy > 0.0f;
      pos[2] |= y.iz > 0.0f;
    }
  }
  // The packet's planes: axis a's near plane is box float a for ix > 0,
  // a + 3 for ix < 0 (inverse components are never 0).
  bool coherent = __all_sync(kFull, finite);
  int off[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool n = __any_sync(kFull, neg[a]);
    coherent &= !(n && __any_sync(kFull, pos[a]));
    off[a] = n ? 3 : 0;
  }
  __syncwarp();  // the warp's previous packet is done with the stack
  for (int s = lane; s < stack_size; s += 32) stack[s] = 0;
  __syncwarp();
  const int caps = kProbe == kNoMt ? 0 : leaf_cap;
  Walk w{0, 0, !__any_sync(kFull, any), 0};
  int steps = 0;
  while (!w.done && steps < max_steps) {
    const int row = kProbe == kNoFetch ? 0 : w.cur;
    const float4 q = __ldg(reinterpret_cast<const float4*>(rows) +
                           static_cast<size_t>(row) * 32 + lane);
    __syncwarp();
    reinterpret_cast<float4*>(s_row)[lane] = q;
    __syncwarp();
    if (__float_as_int(s_row[127]) == 1) {
      const int fc = __float_as_int(s_row[126]);
      const int lcount = fc & 15, lfirst = fc >> 4;
      for (int k = 0; k < caps && k < lcount; ++k) {
#pragma unroll
        for (int j = 0; j < kRays; ++j) tri_test(r[j], s_row + 9 * k, lfirst + k);
      }
      advance<kProbe>(w, 0, 0, stack, stack_size, end_index);
    } else {
      const float* bl = s_row + 16 * (lane & 7);
      const int cp = __float_as_int(bl[6]);
      const unsigned valid = __ballot_sync(kFull, cp >= 0) & 0xffu;
      const unsigned fast =
          coherent ? __ballot_sync(kFull, cp >= 0 && bl[0] <= bl[3] &&
                                              bl[1] <= bl[4] && bl[2] <= bl[5]) &
                         0xffu
                   : 0u;
      unsigned kc = dist_key(kBig);
      if (fast == valid) {
        // Every valid child on the packet's planes: all eight, unrolled;
        // the empty slots' keys are dropped.
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          const unsigned red = child_key(r, s_row + 16 * c, off, true);
          if ((lane & 7) == c && ((valid >> c) & 1u)) kc = red;
        }
      } else {
        for (unsigned mm = valid; mm; mm &= mm - 1) {
          const int c = __ffs(mm) - 1;
          const unsigned red =
              child_key(r, s_row + 16 * c, off, (fast >> c) & 1u);
          if ((lane & 7) == c) kc = red;
        }
      }
      int near;
      const int nchild =
          rank_and_push<kProbe>(kc, cp, lane, w, stack, stack_size, near);
      __syncwarp();
      advance<kProbe>(w, nchild, near, stack, stack_size, end_index);
    }
    ++steps;
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t i = static_cast<size_t>(p) * kLanes + 32 * k + lane;
    t_out[i] = r[k].t;
    u_out[i] = r[k].u;
    v_out[i] = r[k].v;
    tri_out[i] = r[k].tri;
  }
  if (lane == 0) {
    steps_out[p] = steps;
    if (w.n_dropped) atomicAdd(dropped, w.n_dropped);
  }
}

// A persistent grid, five blocks an SM (20 warps; at most 96 registers a
// thread): each warp takes the next packet from `next` (zero at launch)
// until none is left, so a warp whose packet ends starts another at once
// instead of idling until its block's longest packet ends.
template <int kProbe>
__global__ void __launch_bounds__(32 * kPackets, kBlocksPerSm)
    probe_kernel(const float* __restrict__ rows, const float* __restrict__ ox_,
                 const float* __restrict__ oy_, const float* __restrict__ oz_,
                 const float* __restrict__ dx_, const float* __restrict__ dy_,
                 const float* __restrict__ dz_, const float* __restrict__ t0_,
                 const int32_t* __restrict__ act_, float* __restrict__ t_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int32_t* __restrict__ tri_out, int32_t* __restrict__ steps_out,
                 int32_t* __restrict__ dropped, unsigned* __restrict__ next,
                 int n_packets, int end_index, int max_steps, int leaf_cap,
                 int stack_size) {
  extern __shared__ int32_t s_stacks[];
  __shared__ __align__(16) float s_rows[kPackets][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (;;) {
    unsigned p = 0;
    if (lane == 0) p = atomicAdd(next, 1u);
    p = __shfl_sync(kFull, p, 0);
    if (p >= static_cast<unsigned>(n_packets)) return;
    walk_packet<kProbe>(static_cast<int>(p), lane, s_rows[warp],
                        s_stacks + warp * stack_size, rows, ox_, oy_, oz_,
                        dx_, dy_, dz_, t0_, act_, t_out, u_out, v_out,
                        tri_out, steps_out, dropped, end_index, max_steps,
                        leaf_cap, stack_size);
  }
}

template <int kProbe>
int launch(const void* rows, const void* const* in, void* const* out,
           void* dropped, void* next, int n_packets, int end_index,
           int max_steps, int leaf_cap, int stack_size, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n_packets + kPackets - 1) / kPackets;
  const int grid = blocks < sms * kBlocksPerSm ? blocks : sms * kBlocksPerSm;
  const size_t smem = sizeof(int32_t) * stack_size * kPackets;
  auto f = [&](int k) { return static_cast<const float*>(in[k]); };
  auto o = [&](int k) { return static_cast<float*>(out[k]); };
  probe_kernel<kProbe><<<grid, 32 * kPackets, smem, s>>>(
      static_cast<const float*>(rows), f(0), f(1), f(2), f(3), f(4), f(5),
      f(6), static_cast<const int32_t*>(in[7]), o(0), o(1), o(2),
      static_cast<int32_t*>(out[3]), static_cast<int32_t*>(out[4]),
      static_cast<int32_t*>(dropped), static_cast<unsigned*>(next),
      n_packets, end_index, max_steps, leaf_cap, stack_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (ctypes). Ray inputs are (n_packets, 128) float32 (ox, oy,
// oz, dx, dy, dz, t0) and int32 (act); outputs t, u, v (float32), tri
// (int32) of the same shape and steps (n_packets,) int32; ``dropped`` a
// one-int32 counter; ``next`` a one-int32 packet counter, zero at the
// launch. ``probe``: 0 full, 1 nomt, 2 noorder, 3 nostack, 4 nofetch.
// ``stack_size`` at most 2048 (a stack a warp in shared memory). Returns
// the first CUDA error of the device queries and the launch; allocates
// nothing, does not sync.
extern "C" int kernel_probe(const void* rows, const void* ox, const void* oy,
                            const void* oz, const void* dx, const void* dy,
                            const void* dz, const void* t0, const void* act,
                            void* t_out, void* u_out, void* v_out,
                            void* tri_out, void* steps_out, void* dropped,
                            void* next, int n_packets, int end_index,
                            int max_steps, int leaf_cap, int stack_size,
                            int probe, void* stream) {
  if (n_packets <= 0) return 0;
  if (stack_size < 1 || stack_size > kMaxStack) return cudaErrorInvalidValue;
  const void* in[8] = {ox, oy, oz, dx, dy, dz, t0, act};
  void* out[5] = {t_out, u_out, v_out, tri_out, steps_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case kFullProbe:
      return launch<kFullProbe>(rows, in, out, dropped, next, n_packets,
                                end_index, max_steps, leaf_cap, stack_size, s);
    case kNoMt:
      return launch<kNoMt>(rows, in, out, dropped, next, n_packets, end_index,
                           max_steps, leaf_cap, stack_size, s);
    case kNoOrder:
      return launch<kNoOrder>(rows, in, out, dropped, next, n_packets,
                              end_index, max_steps, leaf_cap, stack_size, s);
    case kNoStack:
      return launch<kNoStack>(rows, in, out, dropped, next, n_packets,
                              end_index, max_steps, leaf_cap, stack_size, s);
    case kNoFetch:
      return launch<kNoFetch>(rows, in, out, dropped, next, n_packets,
                              end_index, max_steps, leaf_cap, stack_size, s);
    default:
      return cudaErrorInvalidValue;
  }
}
