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
// Design. One block of 256 threads on one SM (the reference's one grid
// cell): warp w holds row w, each lane four of its elements in registers,
// columns 32 j + lane (strided) or 4 lane + j (contiguous: cgather28, mxu,
// roll, segmin), and the warps run their rows with no block barrier:
// - a read of another element of the row is a shuffle of one register
//   (repeat, bdim, seggather1); roll's shuffle sources are fixed at
//   compile time by a step loop unrolled four times; segmin's first two
//   rounds are mostly within a lane and its 32-lane segments are 8 lanes;
// - a sum the body runs in order (seggather 28 terms, selmerge 56,
//   cgather28 28) runs once a segment on lanes 0-3, which read the terms
//   four at a time (LDS.128) from a per-warp slice of shared memory the
//   warp writes each step (__syncwarp only). The reference starts each
//   such sum from x * 0, which is +0 or -0 for a finite x and NaN
//   otherwise; the lanes start from +0 and every element adds its own
//   x * 0 to the sum: the two differ at most in the sign of a zero sum,
//   which the step's last term (+ i*1e-9, i >= 0) erases, and a NaN start
//   still gives NaN;
// - mxu alone reads other rows: its tile goes through shared memory,
//   double-buffered, with one block barrier a step.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, E3):
// each step's dependent chain within a warp. For the light bodies that is
// a shuffle and two or three dependent float operations (16-27 ns a
// step); for the sums, their 28 or 56 dependent adds (seggather and
// cgather28 140-153 ns, selmerge 241 ns); segmin's five rounds of shuffle
// and min (94 ns); mxu's whole-tile reads from shared memory, 4 KB a warp
// a step (217 ns). The design takes the 1,024-thread barrier and the
// shared-memory round trip out of every body but mxu's, and reads a
// sum's terms four at a time so that the shuffle and load pipes stay off
// the critical path.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kRows = 8, kCols = 128;
constexpr int kThreads = 32 * kRows;
constexpr int kScratch = 160;  // floats of shared memory a warp
constexpr unsigned kFull = 0xffffffffu;

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
struct Layout {
  static constexpr bool kContiguous = kProbe == kCgather28 ||
                                      kProbe == kMxu || kProbe == kRoll ||
                                      kProbe == kSegmin;
  static __device__ __forceinline__ int col(int lane, int j) {
    return kContiguous ? 4 * lane + j : 32 * j + lane;
  }
};

// A lane's sum of 4 kQuads terms of its slice times m, four terms a load,
// in order (m = 1: v * 1 is v).
template <int kQuads>
__device__ __forceinline__ float sum_quads(const float4* src, float m) {
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 v = src[q];
    s = s + v.x * m;
    s = s + v.y * m;
    s = s + v.z * m;
    s = s + v.w * m;
  }
  return s;
}

// roll with i = 4 q + kS: column (4 l + j - i) % 128 is x[(j - kS) % 4] of
// lane (l - q - (j < kS)) % 32.
template <int kS>
__device__ __forceinline__ void roll_step(float (&x)[4], int lane, int i) {
  const int q = (i >> 2) & 31;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __shfl_sync(kFull, x[(j - kS) & 3], (lane - q - (j < kS)) & 31);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = x[j] + v[j] * 1e-7f;
}

// One step of every body but roll's. `sc`: this warp's scratch slice;
// `tile`: mxu's double-buffered tile, `b` its current buffer.
template <int kProbe>
__device__ __forceinline__ void step(float (&x)[4], int w, int lane, int i,
                                     float* sc, float (*tile)[kRows][kCols],
                                     int& b) {
  const float fi = static_cast<float>(i);
  const float fi9 = fi * 1e-9f;
  switch (kProbe) {
    case kRepeat: {  // column c % 4 = lane % 4: x[0] of lane % 4
      const float d = (__shfl_sync(kFull, x[0], lane & 3) + fi) * 1e-6f;
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = x[j] + d;
      break;
    }
    case kBdim:
    case kSeggather1: {  // column c / 32 = j: x[0] of lane j
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __shfl_sync(kFull, x[0], j);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = kProbe == kBdim ? x[j] + (v[j] + fi) * 1e-6f
                               : x[j] + v[j] * 1e-7f + fi9;
      }
      break;
    }
    case kSeggather: {
      // Copy j of columns j, j + 1, ...: sc[36 j + m] = row[j + m]; lane j
      // sums its copy's first 28.
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (lane >= j) sc[36 * j + lane - j] = x[0];
      }
      __syncwarp();
      float s = 0.0f;
      if (lane < 4) {
        s = sum_quads<7>(reinterpret_cast<const float4*>(sc + 36 * lane),
                         1.0f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sj = __shfl_sync(kFull, s, j);
        x[j] = x[j] + (x[j] * 0.0f + sj) * 1e-7f + fi9;
      }
      break;
    }
    case kMxu: {
      // x[k][r] (r = w < 8) and x[k][c] of every row k from the tile.
      const float off = fi * 1e-9f;
      float a[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) a[k] = tile[b][k][w] + off;
      float s[4];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float4 q = reinterpret_cast<const float4*>(tile[b][k])[lane];
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = k == 0 ? a[0] * v[j] : s[j] + a[k] * v[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = x[j] + s[j] * 1e-7f;
      b ^= 1;
      reinterpret_cast<float4*>(tile[b][w])[lane] =
          make_float4(x[0], x[1], x[2], x[3]);
      __syncthreads();
      break;
    }
    case kTranspose: {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = x[j] + x[j] * 1e-7f + fi9;
      break;
    }
    case kSelmerge: {
      // sc[f] = row[2 f] (columns 32 j + l, l even); lane g sums
      // row[2 f] * m[g], f < 56 (m[0] = 1: v * 1 is v).
      __syncwarp();
      if (!(lane & 1)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[16 * j + (lane >> 1)] = x[j];
      }
      __syncwarp();
      float s = 0.0f;
      if (lane < 4) {
        const float m = lane == 0 ? 1.0f
                                  : (lane == 1 ? 1.0000001f
                                               : (lane == 2 ? 1.0000002f
                                                            : 1.0000003f));
        s = sum_quads<14>(reinterpret_cast<const float4*>(sc), m);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sj = __shfl_sync(kFull, s, j);
        x[j] = x[j] + (x[j] * 0.0f + sj) * 1e-9f + fi9;
      }
      break;
    }
    case kCgather28: {
      // The row with 4 floats of padding a segment (segment g at 36 g:
      // lanes 0-3 read distinct banks); lane g sums segment g's first 28.
      __syncwarp();
      reinterpret_cast<float4*>(sc)[lane + (lane >> 3)] =
          make_float4(x[0], x[1], x[2], x[3]);
      __syncwarp();
      float s = 0.0f;
      if (lane < 4) {
        s = sum_quads<7>(reinterpret_cast<const float4*>(sc) + 9 * lane,
                         1.0f);
      }
      const float sg = __shfl_sync(kFull, s, lane >> 3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = x[j] + (x[j] * 0.0f + sg) * 1e-9f + fi9;
      }
      break;
    }
    case kSegmin: {
      // Column 4 l + j: a segment is 8 lanes. Round s reads column
      // (c + s) % 32 of the segment: in the lane or the next ones.
      const int seg = lane & ~7;
      const int n1 = seg | ((lane + 1) & 7), n2 = seg | ((lane + 2) & 7),
                n4 = seg | ((lane + 4) & 7);
      float m[4], y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = x[j] + fi9;
      const float e0 = __shfl_sync(kFull, m[0], n1);  // s = 1
      y[0] = min_nan(m[0], m[1]);
      y[1] = min_nan(m[1], m[2]);
      y[2] = min_nan(m[2], m[3]);
      y[3] = min_nan(m[3], e0);
      const float f0 = __shfl_sync(kFull, y[0], n1);  // s = 2
      const float f1 = __shfl_sync(kFull, y[1], n1);
      m[0] = min_nan(y[0], y[2]);
      m[1] = min_nan(y[1], y[3]);
      m[2] = min_nan(y[2], f0);
      m[3] = min_nan(y[3], f1);
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = min_nan(m[j], __shfl_sync(kFull, m[j], n1));
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = min_nan(y[j], __shfl_sync(kFull, y[j], n2));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = x[j] + min_nan(m[j], __shfl_sync(kFull, m[j], n4)) * 1e-9f;
      }
      break;
    }
  }
}

template <int kProbe>
__global__ void __launch_bounds__(kThreads)
    r3_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
              int steps) {
  using L = Layout<kProbe>;
  __shared__ __align__(16) float scratch[kRows][kScratch];
  __shared__ __align__(16) float tile[kProbe == kMxu ? 2 : 1][kRows][kCols];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = x_in[w * kCols + L::col(lane, j)];
  int b = 0;
  if (kProbe == kMxu) {
    reinterpret_cast<float4*>(tile[0][w])[lane] =
        make_float4(x[0], x[1], x[2], x[3]);
    __syncthreads();
  }
  if (kProbe == kRoll) {
    int i = 0;
    for (; i + 4 <= steps; i += 4) {
      roll_step<0>(x, lane, i);
      roll_step<1>(x, lane, i + 1);
      roll_step<2>(x, lane, i + 2);
      roll_step<3>(x, lane, i + 3);
    }
    if (i < steps) roll_step<0>(x, lane, i);
    if (i + 1 < steps) roll_step<1>(x, lane, i + 1);
    if (i + 2 < steps) roll_step<2>(x, lane, i + 2);
  } else {
    for (int i = 0; i < steps; ++i) {
      step<kProbe>(x, w, lane, i, scratch[w], tile, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) x_out[w * kCols + L::col(lane, j)] = x[j];
}

template <int kProbe>
int launch(const float* x, float* out, int steps, cudaStream_t s) {
  r3_kernel<kProbe><<<1, kThreads, 0, s>>>(x, out, steps);
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
