// E2: per-lane walk over a 1,024-entry node table, the lane-gather probe.
//
// Replaces the TPU kernel experiments/lane_gather_bench.py::_kernel
// (launched by run). Each lane starts at its index within its 128-lane
// row and takes ``steps`` steps: it reads the seven fields of its entry
// (min.xyz, max.xyz and a link word hit | miss << 16), runs the slab test,
// adds tn to its accumulator and moves to the hit link on a hit, else to
// the miss link, modulo 1,024. The plain torch twin is
// loupiote_tpu_torch/experiments/lane_gather_bench.py::lane_gather_plain;
// both add in the same order, so the card's check is bit equality.
//
// Design. One block of 1,024 threads per (8, 128) grid cell, one thread
// per lane; the (7, 1024) table (28 KB) is staged in shared memory, the
// counterpart of the reference's VMEM-resident table, so each step's
// seven gathers are shared-memory loads at data-dependent addresses.
//
// What bounds it on an H100: the steps are serial per lane and each waits
// on its link load from shared memory; the slab test is 25 operations a
// step. With 128 blocks of 1,024 threads the card holds every lane at
// once, so the time is one lane's chain of steps: latency bound.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEntries = 1024;
constexpr int kFields = 7;

__device__ __forceinline__ float inv(float d) {
  return 1.0f / (fabsf(d) > 1e-20f ? d : 1e-20f);
}

__global__ void __launch_bounds__(kEntries)
    lane_gather_kernel(const float* __restrict__ tab,
                       const float* __restrict__ ox_,
                       const float* __restrict__ oy_,
                       const float* __restrict__ oz_,
                       const float* __restrict__ dx_,
                       const float* __restrict__ dy_,
                       const float* __restrict__ dz_, float* __restrict__ out,
                       int steps) {
  __shared__ float s_tab[kFields][kEntries];
  const int e = threadIdx.x;
  for (int f = 0; f < kFields; ++f) s_tab[f][e] = tab[f * kEntries + e];
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * kEntries + e;
  const float ox = ox_[i], oy = oy_[i], oz = oz_[i];
  const float ix = inv(dx_[i]), iy = inv(dy_[i]), iz = inv(dz_[i]);
  int cur = e & 127;
  float acc = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float t1x = (s_tab[0][cur] - ox) * ix;
    const float t2x = (s_tab[3][cur] - ox) * ix;
    const float t1y = (s_tab[1][cur] - oy) * iy;
    const float t2y = (s_tab[4][cur] - oy) * iy;
    const float t1z = (s_tab[2][cur] - oz) * iz;
    const float t2z = (s_tab[5][cur] - oz) * iz;
    const int link = __float_as_int(s_tab[6][cur]);
    const float tn =
        fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tf =
        fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const int nxt = tf >= fmaxf(tn, 0.0f) ? (link & 0xFFFF)
                                          : ((link >> 16) & 0xFFFF);
    cur = nxt & (kEntries - 1);
    acc = acc + tn;
  }
  out[i] = acc;
}

}  // namespace

// C entry point (ctypes). ``tab``: (7, 1024) float32 (the link field's
// bits an int32); rays and ``out``: (n_blocks, 1024) float32. Returns
// cudaGetLastError() after the launch; allocates nothing, does not sync.
extern "C" int lane_gather(const void* tab, const void* ox, const void* oy,
                           const void* oz, const void* dx, const void* dy,
                           const void* dz, void* out, int n_blocks, int steps,
                           void* stream) {
  if (n_blocks <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  lane_gather_kernel<<<n_blocks, kEntries, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      f(tab), f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
