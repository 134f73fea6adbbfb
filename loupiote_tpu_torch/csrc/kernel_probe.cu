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
// Design. One block of 128 threads per sub-packet, one thread per lane.
// Each step the block stages the 512-byte row in shared memory; every
// thread runs its lane's leaf tests or its eight slab tests; eight
// block-wide minima (warp shuffles, then the four warp partials) give the
// children's packet distances; thread 0 ranks the children, pushes and
// pops the stack (stack_size ints of dynamic shared memory) and publishes
// the next row. The variant is a template parameter.
//
// What bounds it on an H100: the steps are serial, each a dependent row
// load (through L2: the arch-260k table is 15.6 MB) plus three block
// barriers and thread 0's serial ranking; the arithmetic per step is a
// few hundred operations per lane. So it is latency bound, and the
// 16,200 blocks of a 1080p wave are what keep the SMs busy.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kWidth = 8;
constexpr int kLeafTag = 1 << 30;
constexpr int kLeafMask = kLeafTag - 1;
constexpr float kBig = 3e30f;
constexpr float kTMin = 1e-4f;

enum Probe { kFull = 0, kNoMt = 1, kNoOrder = 2, kNoStack = 3, kNoFetch = 4 };

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > 1e-20f ? d : (d >= 0.0f ? 1e-20f : -1e-20f);
  return 1.0f / s;
}

template <int kProbe>
__global__ void __launch_bounds__(kLanes)
    probe_kernel(const float* __restrict__ rows, const float* __restrict__ ox_,
                 const float* __restrict__ oy_, const float* __restrict__ oz_,
                 const float* __restrict__ dx_, const float* __restrict__ dy_,
                 const float* __restrict__ dz_, const float* __restrict__ t0_,
                 const int32_t* __restrict__ act_, float* __restrict__ t_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int32_t* __restrict__ tri_out, int32_t* __restrict__ steps_out,
                 int32_t* __restrict__ dropped, int end_index, int max_steps,
                 int leaf_cap, int stack_size) {
  extern __shared__ int32_t s_stack[];
  __shared__ float s_row[kLanes];
  __shared__ float s_part[kWarps][kWidth];
  __shared__ int s_cur, s_done;

  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const size_t i = static_cast<size_t>(blockIdx.x) * kLanes + lane;
  const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
  const float dx = dx_[i], dy = dy_[i], dz = dz_[i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const bool a = act_[i] != 0;
  float t = t0_[i], u = 0.0f, v = 0.0f;
  int tri = -1;
  for (int s = lane; s < stack_size; s += kLanes) s_stack[s] = 0;
  const int caps = kProbe == kNoMt ? 0 : leaf_cap;
  int ptr = 0, n_dropped = 0;  // thread 0's
  int done = !__syncthreads_or(a);
  int cur = 0, steps = 0;
  while (!done && steps < max_steps) {
    const int row = kProbe == kNoFetch ? 0 : cur;
    s_row[lane] = rows[static_cast<size_t>(row) * kLanes + lane];
    __syncthreads();
    const bool leaf = __float_as_int(s_row[127]) == 1;
    int nchild = 0, near = 0;  // thread 0's
    if (leaf) {
      const int fc = __float_as_int(s_row[126]);
      const int lcount = fc & 15;
      const int lfirst = fc >> 4;
      if (a) {
        for (int k = 0; k < caps && k < lcount; ++k) {
          const float* tr = s_row + 9 * k;
          const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
          const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
          const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
          const float pvx = dy * e2z - dz * e2y;
          const float pvy = dz * e2x - dx * e2z;
          const float pvz = dx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
          const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
          const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
          const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
              tt < t) {
            t = tt;
            u = uu;
            v = vv;
            tri = lfirst + k;
          }
        }
      }
    } else {
      float m[kWidth];
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        const float* b = s_row + 16 * c;
        const float t1x = (b[0] - ox) * ix, t2x = (b[3] - ox) * ix;
        const float t1y = (b[1] - oy) * iy, t2y = (b[4] - oy) * iy;
        const float t1z = (b[2] - oz) * iz, t2z = (b[5] - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                               fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                               fmaxf(t1z, t2z));
        m[c] = (a && tf >= fmaxf(tn, 0.0f) && tn < t) ? tn : kBig;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          m[c] = fminf(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
        }
      }
      if ((lane & 31) == 0) {
#pragma unroll
        for (int c = 0; c < kWidth; ++c) s_part[warp][c] = m[c];
      }
      __syncthreads();
      if (lane == 0) {
        // Children's packet distances, hit mask and untagged pointers.
        float tnc[kWidth];
        int ptrs[kWidth];
        int hit = 0;
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          float x = s_part[0][c];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) x = fminf(x, s_part[w][c]);
          tnc[c] = x;
          const int cp = __float_as_int(s_row[16 * c + 6]);
          ptrs[c] = cp >= 0 ? (cp & kLeafMask) : cp;
          if (x < kBig && cp >= 0) hit |= 1 << c;
        }
        nchild = __popc(hit);
        // Rank each hit child; descend the nearest, push the others
        // farthest-first above the stack pointer.
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
          if (!((hit >> c) & 1)) continue;
          int r = 0;
          if (kProbe == kNoOrder) {
            r = __popc(hit & ((1 << c) - 1));
          } else {
#pragma unroll
            for (int q = 0; q < kWidth; ++q) {
              if (((hit >> q) & 1) &&
                  (tnc[q] < tnc[c] || (tnc[q] == tnc[c] && q < c))) {
                ++r;
              }
            }
          }
          if (r == 0) {
            near = ptrs[c];
          } else if (kProbe != kNoStack) {
            const int pc = ptr + nchild - 1 - r;
            if (pc < stack_size) {
              s_stack[pc] = ptrs[c];
            } else {
              ++n_dropped;
            }
          }
        }
      }
    }
    if (lane == 0) {
      const bool descend = nchild > 0;
      const int pos = kProbe != kNoStack && descend ? ptr + nchild - 1 : ptr;
      const int top = pos - 1 > 0 ? pos - 1 : 0;
      const int popped = top < stack_size ? s_stack[top] : 0;
      const int nxt = descend ? near : (pos > 0 ? popped : end_index);
      ptr = descend ? pos : top;
      const bool fin = nxt >= end_index;
      s_cur = fin ? 0 : nxt;
      s_done = fin;
    }
    __syncthreads();
    cur = s_cur;
    done = s_done;
    ++steps;
  }
  t_out[i] = t;
  u_out[i] = u;
  v_out[i] = v;
  tri_out[i] = tri;
  if (lane == 0) {
    steps_out[blockIdx.x] = steps;
    if (n_dropped) atomicAdd(dropped, n_dropped);
  }
}

template <int kProbe>
int launch(const void* rows, const void* const* in, void* const* out,
           void* dropped, int n_packets, int end_index, int max_steps,
           int leaf_cap, int stack_size, cudaStream_t s) {
  const size_t smem = sizeof(int32_t) * stack_size;
  auto f = [&](int k) { return static_cast<const float*>(in[k]); };
  auto o = [&](int k) { return static_cast<float*>(out[k]); };
  probe_kernel<kProbe><<<n_packets, kLanes, smem, s>>>(
      static_cast<const float*>(rows), f(0), f(1), f(2), f(3), f(4), f(5),
      f(6), static_cast<const int32_t*>(in[7]), o(0), o(1), o(2),
      static_cast<int32_t*>(out[3]), static_cast<int32_t*>(out[4]),
      static_cast<int32_t*>(dropped), end_index, max_steps, leaf_cap,
      stack_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (ctypes). Ray inputs are (n_packets, 128) float32 (ox, oy,
// oz, dx, dy, dz, t0) and int32 (act); outputs t, u, v (float32), tri
// (int32) of the same shape and steps (n_packets,) int32; ``dropped`` a
// one-int32 counter. ``probe``: 0 full, 1 nomt, 2 noorder, 3 nostack,
// 4 nofetch. Returns cudaGetLastError() after the launch; allocates
// nothing, does not sync.
extern "C" int kernel_probe(const void* rows, const void* ox, const void* oy,
                            const void* oz, const void* dx, const void* dy,
                            const void* dz, const void* t0, const void* act,
                            void* t_out, void* u_out, void* v_out,
                            void* tri_out, void* steps_out, void* dropped,
                            int n_packets, int end_index, int max_steps,
                            int leaf_cap, int stack_size, int probe,
                            void* stream) {
  if (n_packets <= 0) return 0;
  if (stack_size < 1 || stack_size > 8192) return cudaErrorInvalidValue;
  const void* in[8] = {ox, oy, oz, dx, dy, dz, t0, act};
  void* out[5] = {t_out, u_out, v_out, tri_out, steps_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case kFull:
      return launch<kFull>(rows, in, out, dropped, n_packets, end_index,
                           max_steps, leaf_cap, stack_size, s);
    case kNoMt:
      return launch<kNoMt>(rows, in, out, dropped, n_packets, end_index,
                           max_steps, leaf_cap, stack_size, s);
    case kNoOrder:
      return launch<kNoOrder>(rows, in, out, dropped, n_packets, end_index,
                              max_steps, leaf_cap, stack_size, s);
    case kNoStack:
      return launch<kNoStack>(rows, in, out, dropped, n_packets, end_index,
                              max_steps, leaf_cap, stack_size, s);
    case kNoFetch:
      return launch<kNoFetch>(rows, in, out, dropped, n_packets, end_index,
                              max_steps, leaf_cap, stack_size, s);
    default:
      return cudaErrorInvalidValue;
  }
}
