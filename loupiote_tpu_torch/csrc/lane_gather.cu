// E2: per-lane walk over a 1,024-entry node table, the lane-gather probe.
//
// Replaces the TPU kernel experiments/lane_gather_bench.py::_kernel
// (launched by run). Each lane starts at its index within its 128-lane
// row and takes ``steps`` steps: it reads the seven fields of its entry
// (min.xyz, max.xyz and a link word hit | miss << 16), runs the slab test,
// adds tn to its accumulator and moves to the hit link on a hit, else to
// the miss link, modulo 1,024. The plain torch twin is
// loupiote_tpu_torch/experiments/lane_gather_bench.py::lane_gather_plain;
// both add in the same order and take min / max that return NaN where an
// operand is NaN (torch.minimum / maximum), so the card's check is bit
// equality, NaN counted equal to NaN.
//
// What bounds it on an H100: each step of each lane reads one entry at a
// data-dependent index from shared memory, so a warp's 32 lanes fall on
// random banks; the seven 4-byte loads of the first design took ~24
// wavefronts a warp-step (one 128-byte wavefront a clock an SM), and the
// shared-memory pipe set the pace. The steps are serial per lane, and the
// card holds every lane of the probe's 128 x 1,024 at once (32 warps an
// SM), so no other parallelism hides that.
//
// Design. The table is staged once per block in dynamic shared memory,
// packed as three arrays read with one 16-, one 8- and one 4-byte load a
// step: (minx, miny, minz, maxx), (maxy, maxz) and hit | miss << 16, the
// links masked to 1,024 and scaled to element indices when staged. Each
// array holds kCopies copies, interleaved entry by entry (copy c of entry
// e is element e * kCopies + c), and lane l reads copy l mod kCopies: the
// eight lanes of a quarter-warp each read their own 16-byte bank group,
// which leaves the 8- and 4-byte loads as the only ones that conflict,
// ~11 wavefronts a warp-step (28 bytes x 1,024 entries x 8 copies =
// 229,376 bytes, one block an SM). The grid is the reference's, G blocks
// of 1,024 lanes: 128 x 1,024 lanes make 4,096 warps, so some SM holds 32
// of them however the lanes are split over the card's 132, and a split
// over every SM measured no faster.
// min / max are PTX min.NaN / max.NaN. A step is then ~35 instructions,
// 17 of them on the ALU pipe, which runs 16 lanes a clock a scheduler
// (11 FMNMX, 3 LEA, 2 for the link's halves, FSETP): that pipe and the
// shared-memory pipe now bound it about equally.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kEntries = 1024;
constexpr int kThreads = 1024;
constexpr int kCopies = 8;
constexpr int kSmemBytes = (16 + 8 + 4) * kCopies * kEntries;

__device__ __forceinline__ float inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__global__ void __launch_bounds__(kThreads, 1)
    lane_gather_kernel(const float* __restrict__ tab,
                       const float* __restrict__ ox_,
                       const float* __restrict__ oy_,
                       const float* __restrict__ oz_,
                       const float* __restrict__ dx_,
                       const float* __restrict__ dy_,
                       const float* __restrict__ dz_, float* __restrict__ out,
                       int steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_lo = reinterpret_cast<float4*>(smem);
  float2* s_hi = reinterpret_cast<float2*>(s_lo + kCopies * kEntries);
  int* s_link = reinterpret_cast<int*>(s_hi + kCopies * kEntries);
  // Thread x stages element x of each array, so a warp's stores are
  // consecutive; copies of one entry read its fields from L1.
  for (int x = threadIdx.x; x < kCopies * kEntries; x += blockDim.x) {
    const int e = x / kCopies;
    s_lo[x] = make_float4(tab[e], tab[kEntries + e], tab[2 * kEntries + e],
                          tab[3 * kEntries + e]);
    s_hi[x] = make_float2(tab[4 * kEntries + e], tab[5 * kEntries + e]);
    const int link = __float_as_int(tab[6 * kEntries + e]);
    const int hit = (link & (kEntries - 1)) * kCopies;
    const int miss = ((link >> 16) & (kEntries - 1)) * kCopies;
    s_link[x] = hit | (miss << 16);
  }
  __syncthreads();
  const long long i = blockIdx.x * static_cast<long long>(kThreads)
                      + threadIdx.x;
  const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
  const float ix = inv(dx_[i]), iy = inv(dy_[i]), iz = inv(dz_[i]);
  const int copy = threadIdx.x % kCopies;
  // cur: the entry's first element, entry * kCopies.
  int cur = static_cast<int>(i & 127) * kCopies;
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float4 lo = s_lo[cur + copy];
    const float2 hi = s_hi[cur + copy];
    const int link = s_link[cur + copy];
    const float t1x = (lo.x - ox) * ix;
    const float t2x = (lo.w - ox) * ix;
    const float t1y = (lo.y - oy) * iy;
    const float t2y = (hi.x - oy) * iy;
    const float t1z = (lo.z - oz) * iz;
    const float t2z = (hi.y - oz) * iz;
    const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                             min_nan(t1z, t2z));
    const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                             max_nan(t1z, t2z));
    // A NaN tn or tf fails the test: the miss link, as in the twin.
    cur = tf >= max_nan(tn, 0.0f)
              ? (link & 0xFFFF)
              : static_cast<int>(static_cast<unsigned>(link) >> 16);
    acc = acc + tn;
  }
  out[i] = acc;
}

}  // namespace

// C entry point (ctypes). ``tab``: (7, 1024) float32 (the link field's
// bits an int32); rays and ``out``: (n_blocks, 1024) float32. Sets the
// kernel's dynamic shared memory limit and returns its error if that is
// refused, else cudaGetLastError() after the launch; allocates nothing,
// does not sync.
extern "C" int lane_gather(const void* tab, const void* ox, const void* oy,
                           const void* oz, const void* dx, const void* dy,
                           const void* dz, void* out, int n_blocks, int steps,
                           void* stream) {
  if (n_blocks <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      lane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  lane_gather_kernel<<<n_blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      f(tab), f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

