// E5: run scatter of the counting regroup.
//
// Replaces the TPU kernel experiments/treelet/regroup.py::_scatter_kernel
// (wrapped by scatter_runs): for each slab g, copy its key runs
// data2[g, src : src + len] to out[dst : dst + len]. The plain twin is
// loupiote_tpu_torch/treelet/regroup.py::scatter_runs_plain.
//
// No spill. The TPU kernel copies 256-element chunks and lets the last
// chunk of a run write up to 255 junk elements past its end; that is safe
// there only because grid cells run in order, so a later cell overwrites
// the spill. GPU blocks run concurrently, and such a spill would race with
// another slab's copy. This kernel copies exactly len elements into an
// output the wrapper zero-fills, so destinations are disjoint and the
// result does not depend on the order blocks run in.
//
// Design: one block per slab; the block walks its runs in order and its
// threads stride over each run's elements, so neighbouring threads read
// and write neighbouring addresses.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (8.3 M pairs x 8 bytes on the treelet path, plus the zero fill of
// the output by the wrapper), with no arithmetic to speak of. Short runs
// (a slab of 65,536 pairs holds up to a few hundred runs) leave threads of
// the block idle at each run's end.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    scatter_runs_kernel(const int32_t* __restrict__ data2,
                        const int32_t* __restrict__ nruns,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ dst,
                        const int32_t* __restrict__ lens,
                        int32_t* __restrict__ out, int sp, int maxr,
                        int out_rows) {
  const int g = blockIdx.x;
  const int32_t* row = data2 + static_cast<size_t>(g) * sp;
  const int nr = nruns[g];
  for (int r = 0; r < nr; ++r) {
    const size_t e = static_cast<size_t>(g) * maxr + r;
    const int s = src[e], d = dst[e], len = lens[e];
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int o = d + i;
      if (o < out_rows && s + i < sp) out[o] = row[s + i];
    }
  }
}

}  // namespace

// C entry point (ctypes). Pointers from tensor.data_ptr(): data2 (g, sp),
// nruns (g,), src/dst/lens (g, maxr) int32, out (out_rows,) int32 zeroed
// by the caller; ``stream``: the caller's CUDA stream. Returns
// cudaGetLastError() after the launch; allocates nothing, does not sync.
extern "C" int scatter_runs(const void* data2, const void* nruns,
                            const void* src, const void* dst,
                            const void* lens, void* out, int g, int sp,
                            int maxr, int out_rows, void* stream) {
  if (g <= 0) return 0;
  scatter_runs_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data2), static_cast<const int32_t*>(nruns),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(lens), static_cast<int32_t*>(out), sp, maxr,
      out_rows);
  return static_cast<int>(cudaGetLastError());
}
