// K4: slab-local bitonic sort of int32 keys carrying up to 4 int32 payload
// columns.
//
// Replaces the TPU kernel loupiote_tpu/ops/slab_sort.py::_slab_kernel
// (launched by _slab_sort_padded, wrapped by slab_sort). It applies the
// same compare-exchange network: for k = 1..c_log, j = k-1..0, the pair
// (i, i ^ (1 << j)) ascends where bit k of the in-slab index i is clear
// (the whole slab at k = c_log); the compares are strict, so equal keys
// never swap, and every payload column follows the key. The network fixes
// the result, so keys and the payload order among equal keys agree bit for
// bit with the reference and with the plain twin
// loupiote_tpu_torch/ops/slab_sort.py::slab_sort_plain.
//
// Data: one int32 matrix (1 + n_payload, n), row 0 the keys, n a multiple
// of the slab 2^c_log; sorted in place.
//
// Design. A 2^16-key slab with one payload is 512 KB: more than one
// block's shared memory (227 KB), and 127 such slabs exceed the 50 MB L2.
// So the stages with d < 4096 run in shared memory, on 4,096-key chunks
// (16 KB per column), and each stage with d >= 4096 is one pass over
// device memory, one thread per compare-exchange:
//   launch 1:            k = 1..12, every j, in shared memory;
//   for k = 13..c_log:   one global pass for each j >= 12, then one
//                        shared-memory launch for j = 11..0.
// For c_log = 16 that is 1 + 2 + 3 + 4 + 5 = 15 launches.
//
// What bounds it on an H100: compare-exchanges are a few integer ops each
// (c_log (c_log + 1) / 2 = 136 stages of n/2 pairs), so it is not bound by
// operations. The 10 global passes each read and write the matrix once:
// 10 x 2 x 8.3 M x 8 bytes = 1.3 GB at one payload for the treelet path's
// 8.3 M pairs, about 0.4 ms at 3.35 TB/s against the 0.04 ms that one
// read and one write of the data need. Fewer global passes (a larger
// shared chunk, several stages a pass in registers) are later work.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPayload = 4;  // ops/slab_sort.py: MAX_PAYLOAD
constexpr int kChunkLog = 12;   // ops/slab_sort.py: CHUNK_LOG
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ bool ascending(long long in_slab, int k) {
  return ((in_slab >> k) & 1) == 0;
}

// Stages k in [k_lo, k_hi], for each j = min(k - 1, chunk_log - 1) .. 0,
// on one chunk of 2^chunk_log keys held in shared memory.
__global__ void slab_local_kernel(int32_t* __restrict__ mat, int n_payload,
                                  long long n, int c_log, int chunk_log,
                                  int k_lo, int k_hi) {
  extern __shared__ int32_t sm[];
  const int C = 1 << chunk_log;
  const long long base = static_cast<long long>(blockIdx.x) * C;
  const int rows = 1 + n_payload;
  for (int r = 0; r < rows; ++r) {
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      sm[r * C + i] = mat[r * n + base + i];
    }
  }
  __syncthreads();
  const long long slab_mask = (1ll << c_log) - 1;
  for (int k = k_lo; k <= k_hi; ++k) {
    const int j_top = (k - 1 < chunk_log - 1) ? k - 1 : chunk_log - 1;
    for (int j = j_top; j >= 0; --j) {
      const int d = 1 << j;
      for (int p = threadIdx.x; p < C / 2; p += blockDim.x) {
        const int lo = ((p >> j) << (j + 1)) | (p & (d - 1));
        const int hi = lo + d;
        const bool asc = ascending((base + lo) & slab_mask, k);
        const int32_t a = sm[lo], b = sm[hi];
        if (asc ? (b < a) : (a < b)) {
          for (int r = 0; r < rows; ++r) {
            const int32_t x = sm[r * C + lo];
            sm[r * C + lo] = sm[r * C + hi];
            sm[r * C + hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = 0; r < rows; ++r) {
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      mat[r * n + base + i] = sm[r * C + i];
    }
  }
}

// One stage (k, j) with d = 2^j >= the chunk, in device memory.
__global__ void slab_global_kernel(int32_t* __restrict__ mat, int n_payload,
                                   long long n, int c_log, int k, int j) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const long long d = 1ll << j;
  const long long lo = ((p >> j) << (j + 1)) | (p & (d - 1));
  const long long hi = lo + d;
  const bool asc = ascending(lo & ((1ll << c_log) - 1), k);
  const int32_t a = mat[lo], b = mat[hi];
  if (asc ? (b < a) : (a < b)) {
    for (int r = 0; r <= n_payload; ++r) {
      const int32_t x = mat[r * n + lo];
      mat[r * n + lo] = mat[r * n + hi];
      mat[r * n + hi] = x;
    }
  }
}

}  // namespace

// C entry point (ctypes). ``mat``: device pointer to the (1 + n_payload, n)
// int32 matrix, n a multiple of 2^c_log; ``stream``: the caller's CUDA
// stream. Issues every launch of one sort; returns cudaGetLastError()
// after the last (or the first failing) launch; allocates nothing, does
// not sync.
extern "C" int slab_sort(void* mat, int n_payload, long long n, int c_log,
                         void* stream) {
  if (n <= 0) return 0;
  if (n_payload < 0 || n_payload > kMaxPayload) return cudaErrorInvalidValue;
  if (n % (1ll << c_log) != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<int32_t*>(mat);
  const int chunk_log = c_log < kChunkLog ? c_log : kChunkLog;
  const int C = 1 << chunk_log;
  const size_t smem = sizeof(int32_t) * C * (1 + n_payload);
  cudaError_t err = cudaFuncSetAttribute(
      slab_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 local_grid(static_cast<unsigned>(n / C));
  const dim3 local_block(C / 2 < 1024 ? C / 2 : 1024);
  const dim3 global_grid(
      static_cast<unsigned>((n / 2 + kGlobalThreads - 1) / kGlobalThreads));
  slab_local_kernel<<<local_grid, local_block, smem, s>>>(
      m, n_payload, n, c_log, chunk_log, 1, chunk_log);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int k = chunk_log + 1; k <= c_log; ++k) {
    for (int j = k - 1; j >= chunk_log; --j) {
      slab_global_kernel<<<global_grid, kGlobalThreads, 0, s>>>(
          m, n_payload, n, c_log, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    slab_local_kernel<<<local_grid, local_block, smem, s>>>(
        m, n_payload, n, c_log, chunk_log, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
