// E3: op-latency probes on one (8, 128) float32 tile.
//
// Replaces the TPU kernel experiments/r3_probes.py::run_probe.kernel
// (launched by run_probe.run): a loop of ``steps`` iterations of one of
// the ten step bodies of probe_body, on one tile, in one grid cell. Each
// body is evaluated as the reference writes it, left to right, with its
// float32 constants; i is the step index as a float:
//   repeat      x + (x[r, c % 4] + i) * 1e-6
//   bdim        x + (x[r, c / 32] + i) * 1e-6
//   seggather   x + (x*0 + sum_{k<28} x[r, (c/32 + k) % 128]) * 1e-7 + i*1e-9
//   seggather1  x + x[r, c / 32] * 1e-7 + i*1e-9
//   mxu         x + (sum_{k<8} (x[k, r] + i*1e-9) * x[k, c]) * 1e-7
//   transpose   x + x * 1e-7 + i*1e-9
//   selmerge    x + (x*0 + sum_{f<56} x[r, 2f % 128] * m[c / 32]) * 1e-9
//                 + i*1e-9, m = (none, 1.0000001, 1.0000002, 1.0000003)
//   cgather28   x + (x*0 + sum_{f<28} x[r, 32 (c/32) + f]) * 1e-9 + i*1e-9
//   roll        x + x[r, (c - i) % 128] * 1e-7
//   segmin      m = x + i*1e-9, then 5 rounds m = min(m, m[r, 32 (c/32) +
//               (c + s) % 32]), s = 1, 2, 4, 8, 16; x + m * 1e-9
// (sums in index order). mxu's product is computed here, in k order, not
// by a library call. The plain torch twin is
// loupiote_tpu_torch/experiments/r3_probes.py::probe_plain; both round
// every operation alike, so the card's check is bit equality.
//
// Design. One block of 1,024 threads, one per element, as the reference
// runs one grid cell; the tile sits double-buffered in shared memory and
// the block meets at one barrier a step. segmin's 32-lane segments are
// warps, so its rounds are warp shuffles. The probe is a template
// parameter.
//
// What bounds it on an H100: one block on one SM, a barrier every step,
// and each step's few to few hundred operations per thread; the per-step
// latency (the slope between two step counts) is what the probe measures.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8, kCols = 128, kTile = kRows * kCols;

enum Probe {
  kRepeat = 0,
  kBdim,
  kSeggather,
  kSeggather1,
  kMxu,
  kTranspose,
  kSelmerge,
  kCgather28,
  kRoll,
  kSegmin,
  kNumProbes
};

template <int kProbe>
__device__ __forceinline__ float step(const float* x, int r, int c, int i) {
  const float xe = x[r * kCols + c];
  const float* row = x + r * kCols;
  const float fi = static_cast<float>(i);
  switch (kProbe) {
    case kRepeat:
      return xe + (row[c & 3] + fi) * 1e-6f;
    case kBdim:
      return xe + (row[c >> 5] + fi) * 1e-6f;
    case kSeggather: {
      float acc = xe * 0.0f;
      for (int k = 0; k < 28; ++k) acc = acc + row[((c >> 5) + k) & 127];
      return xe + acc * 1e-7f + fi * 1e-9f;
    }
    case kSeggather1:
      return xe + row[c >> 5] * 1e-7f + fi * 1e-9f;
    case kMxu: {
      const float off = fi * 1e-9f;
      float s = (x[r] + off) * x[c];
      for (int k = 1; k < kRows; ++k) {
        s = s + (x[k * kCols + r] + off) * x[k * kCols + c];
      }
      return xe + s * 1e-7f;
    }
    case kTranspose:
      return xe + xe * 1e-7f + fi * 1e-9f;
    case kSelmerge: {
      const int g = c >> 5;
      const float m = g == 1 ? 1.0000001f : (g == 2 ? 1.0000002f : 1.0000003f);
      float acc = xe * 0.0f;
      for (int f = 0; f < 56; ++f) {
        const float val = row[(f * 2) & 127];
        acc = acc + (g == 0 ? val : val * m);
      }
      return xe + acc * 1e-9f + fi * 1e-9f;
    }
    case kCgather28: {
      const int base = c & ~31;
      float acc = xe * 0.0f;
      for (int f = 0; f < 28; ++f) acc = acc + row[base + f];
      return xe + acc * 1e-9f + fi * 1e-9f;
    }
    case kRoll:
      return xe + row[(c - (i & 127)) & 127] * 1e-7f;
    case kSegmin: {
      float m = xe + fi * 1e-9f;
      const int lane = c & 31;  // a 32-lane segment is one warp
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        m = fminf(m, __shfl_sync(0xffffffffu, m, (lane + s) & 31));
      }
      return xe + m * 1e-9f;
    }
  }
  return xe;
}

template <int kProbe>
__global__ void __launch_bounds__(kTile)
    r3_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
              int steps) {
  __shared__ float buf[2][kTile];
  const int e = threadIdx.x;
  const int r = e / kCols, c = e % kCols;
  buf[0][e] = x_in[e];
  __syncthreads();
  int b = 0;
  for (int i = 0; i < steps; ++i) {
    buf[b ^ 1][e] = step<kProbe>(buf[b], r, c, i);
    __syncthreads();
    b ^= 1;
  }
  x_out[e] = buf[b][e];
}

template <int kProbe>
int launch(const float* x, float* out, int steps, cudaStream_t s) {
  r3_kernel<kProbe><<<1, kTile, 0, s>>>(x, out, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (ctypes). ``x``, ``out``: (8, 128) float32 tiles on the
// card; ``probe``: the index of the body in the order of the comment
// above. Returns cudaGetLastError() after the launch; allocates nothing,
// does not sync.
extern "C" int r3_probe(const void* x, void* out, int steps, int probe,
                        void* stream) {
  auto* in = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case kRepeat: return launch<kRepeat>(in, o, steps, s);
    case kBdim: return launch<kBdim>(in, o, steps, s);
    case kSeggather: return launch<kSeggather>(in, o, steps, s);
    case kSeggather1: return launch<kSeggather1>(in, o, steps, s);
    case kMxu: return launch<kMxu>(in, o, steps, s);
    case kTranspose: return launch<kTranspose>(in, o, steps, s);
    case kSelmerge: return launch<kSelmerge>(in, o, steps, s);
    case kCgather28: return launch<kCgather28>(in, o, steps, s);
    case kRoll: return launch<kRoll>(in, o, steps, s);
    case kSegmin: return launch<kSegmin>(in, o, steps, s);
    default: return cudaErrorInvalidValue;
  }
}
