// K4: slab-local bitonic sort of int32 keys carrying up to 4 int32 payload
// rows, scheduled for Hopper's thread-block clusters.
//
// Replaces the TPU kernel loupiote_tpu/ops/slab_sort.py:81 _slab_kernel
// (launched by _slab_sort_padded, wrapped by slab_sort) and, through
// loupiote_tpu_torch/treelet/device_sort.py (E4: one slab spanning the
// array), the global bitonic sort of experiments/treelet/device_sort.py:
// 81, 92, 102 (_chunk_sort_kernel, _descent_kernel, _cross_kernel). It
// applies the reference's compare-exchange network: for k = 1..c_log,
// j = k-1..0, the pair (i, i ^ (1 << j)) ascends where bit k of the
// in-slab index i is clear (the whole slab at k = c_log); the compares are
// strict, so equal keys never swap, and every payload row follows the key.
// Any schedule that applies the stages in this order gives the same
// matrix, so keys and the payload order among equal keys agree bit for
// bit with the reference and with the plain twin
// loupiote_tpu_torch/ops/slab_sort.py::slab_sort_plain.
//
// Data: one int32 matrix (1 + n_payload, n), row 0 the keys, n a multiple
// of the slab 2^c_log; sorted in place.
//
// The launch plan. loupiote_tpu_torch/ops/slab_sort.py::launch_plan
// computes the ordered launches and passes them here as int32 quadruples;
// this file runs them as given and plans nothing itself. A cluster of
// 2^(span - b) blocks holds 2^span keys (span = min(span_log, c_log)),
// 2^b keys and every payload row in each block's shared memory:
//   (0, k_lo, k_hi, j_top): one cluster launch: for k = k_lo..k_hi and
//       j = min(k - 1, j_top)..0, one load of the matrix and one store;
//   (1, k, j_hi, j_lo): one pass over device memory for the stages
//       j = j_hi..j_lo (d >= 2^span, at most global_stages(rows)) of
//       level k, each thread holding the 2^(j_hi - j_lo + 1) keys of its
//       group in registers.
// Inside a cluster launch a stage runs where its partner lies: j < 5 in
// the warp (__shfl_xor_sync), j in the thread's register bits in
// registers, j >= b in another block of the cluster, read through
// distributed shared memory. The thread's register bits are a window
// [lo, lo + 5) of the index that moves down with j; each move is one
// store and one load of shared memory (a "phase").
//
// Keys are held XORed with -1 where their pair descends at the level being
// applied (flip below), so every compare-exchange is an ascending min/max.
//
// What bounds it on an H100. The treelet path (8,294,400 pair keys, 127
// slabs of 2^16, one payload, c_log 16 <= span 17) is one launch, one
// read and one write of the 66.6 MB matrix: 0.04 ms at 3.35 TB/s, as on
// the TPU. Its 136 stages then run on chip, with 8 blocks of 2^13 keys a
// cluster: 70 as warp shuffles (two a key and stage, so the SMs' shuffle
// rate bounds them), 60 in registers, 6 across blocks, with 13 phase moves
// through shared memory (its bandwidth bounds them); the on-chip work,
// not bytes, bounds the launch. E4 (2^23 keys, c_log 23 > span 17) needs
// 6 global passes and 7 cluster launches (13 instead of 78), each reading
// and writing the 67 MB matrix: 13 x 134 MB = 1.7 GB, 0.52 ms at 3.35
// TB/s; there the six one-level cluster launches, each one round trip
// for 17 stages with 3 exchanges across blocks, cost most. The previous
// design ran every stage with d >= 4,096 as its own pass over device
// memory (15 launches on the treelet path, 78 for E4).
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPayload = 4;      // ops/slab_sort.py: MAX_PAYLOAD
constexpr int kSmemBytes = 232448;  // ops/slab_sort.py: SMEM_BYTES
constexpr int kClusterLog = 3;      // ops/slab_sort.py: CLUSTER_LOG
constexpr int kPassRegisters = 128; // ops/slab_sort.py: PASS_REGISTERS
constexpr int kLaneLog = 5;
constexpr int kGlobalThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Keys a thread holds in registers in a cluster launch, log2: 32 at
// every row count (ROWS x 32 values; at four and five rows a block has
// 256 threads, so a thread may use 255 registers).
constexpr int kElemLog = 5;
constexpr int kElems = 1 << kElemLog;

// The most keys a block holds, log2: every row in shared memory.
__host__ __device__ constexpr int block_log_max(int rows) {
  int b = 0;
  while ((4 << (b + 1)) * rows <= kSmemBytes) ++b;
  return b;
}

// Stages a global pass applies, at most: 2^m keys and their payloads a
// thread, at most kPassRegisters values (half the registers a thread may
// use); ops/slab_sort.py: global_stages.
__host__ __device__ constexpr int global_stages(int rows) {
  int m = 0;
  while (rows << (m + 1) <= kPassRegisters) ++m;
  return m;
}

__host__ __device__ constexpr int max_threads(int rows) {
  return 1 << (block_log_max(rows) - kElemLog);
}

// Register 0's local index in a phase whose register bits are
// [lo, lo + 5): lane bits 0..4, the warp index in the other bits.
__device__ __forceinline__ int phase_base(int lo, int lane, int warp) {
  const int wb = lo - kLaneLog;
  return lane | ((warp & ((1 << wb) - 1)) << kLaneLog) |
         ((warp >> wb) << (lo + kElemLog));
}

template <int ROWS>
__device__ __forceinline__ void load_phase(const int32_t* sm, int B, int l0,
                                           int lo,
                                           int32_t (&v)[ROWS][kElems]) {
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r][q] = sm[r * B + l0 + (q << lo)];
  }
}

template <int ROWS>
__device__ __forceinline__ void store_phase(int32_t* sm, int B, int l0, int lo,
                                            int32_t (&v)[ROWS][kElems]) {
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sm[r * B + l0 + (q << lo)] = v[r][q];
  }
}

// -1 where bit k of in-slab index i is set (the pair descends at level
// k), else 0. A kernel holds each key XORed with the mask of the level it
// is at: bitwise not reverses the int32 order, so every compare-exchange
// of the level is an ascending one on the held keys, strict compares and
// ties included, and no stage computes a direction.
__device__ __forceinline__ int32_t flip(unsigned i, int k) {
  return -static_cast<int32_t>((i >> k) & 1u);
}

// One stage with its partner C register bits away: the pair (q, q | 2^C)
// keeps (min, max) of the held keys and swaps payloads where the upper key
// is the smaller.
template <int ROWS, int C>
__device__ __forceinline__ void reg_stage(int32_t (&v)[ROWS][kElems]) {
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    if (q & (1 << C)) continue;
    const int q2 = q | (1 << C);
    const int32_t a = v[0][q], c = v[0][q2];
    const bool sw = c < a;
    v[0][q] = min(a, c);
    v[0][q2] = max(a, c);
#pragma unroll
    for (int r = 1; r < ROWS; ++r) {
      const int32_t x = v[r][q], y = v[r][q2];
      v[r][q] = sw ? y : x;
      v[r][q2] = sw ? x : y;
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void reg_stage_at(int c,
                                             int32_t (&v)[ROWS][kElems]) {
  switch (c) {
    case 0: reg_stage<ROWS, 0>(v); break;
    case 1: reg_stage<ROWS, 1>(v); break;
    case 2: reg_stage<ROWS, 2>(v); break;
    case 3: reg_stage<ROWS, 3>(v); break;
    default: reg_stage<ROWS, 4>(v); break;
  }
}

// One stage with its partner in another lane of the warp (j < 5). Each
// lane keeps the minimum (lower lane) or the maximum (upper lane) of its
// pair, as the TPU kernel's elements do, and takes its partner's payload
// where its key changed: strict compares, so ties keep their own.
template <int ROWS>
__device__ __forceinline__ void shfl_stage(int32_t (&v)[ROWS][kElems], int j,
                                           int lane) {
  const int d = 1 << j;
  const bool up = (lane & d) != 0;
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    const int32_t kx = v[0][q];
    const int32_t kp = __shfl_xor_sync(kFull, kx, d);
    const int32_t nk = up ? max(kx, kp) : min(kx, kp);
    const bool sel = nk != kx;
    v[0][q] = nk;
#pragma unroll
    for (int r = 1; r < ROWS; ++r) {
      const int32_t p = __shfl_xor_sync(kFull, v[r][q], d);
      v[r][q] = sel ? p : v[r][q];
    }
  }
}

// One stage with its partner in block rank ^ 2^(j - b) of the cluster, at
// the same local index. Every block reads its own and its partner's
// shared memory, and after a cluster barrier writes only its own; each key
// keeps the minimum (lower block) or the maximum (upper block) of its pair
// and takes its partner's payload where it changed. (Loads of 16 bytes, and
// one exchange for all of a level's stages j >= b, measured slower on the
// H100: PERF.md, Findings.)
template <int ROWS>
__device__ __forceinline__ void cross_stage(cg::cluster_group& cluster,
                                            int32_t* sm, int B, int T,
                                            unsigned ib0, int b, int j,
                                            int32_t (&v)[ROWS][kElems]) {
  const int32_t* rem =
      cluster.map_shared_rank(sm, cluster.block_rank() ^ (1u << (j - b)));
  const bool up = ((ib0 >> j) & 1) != 0;
  cluster.sync();  // every block's shared memory holds the last stage
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    const int l = threadIdx.x + q * T;
    const int32_t kx = sm[l], kp = rem[l];
    const int32_t nk = up ? max(kx, kp) : min(kx, kp);
    const bool sel = nk != kx;
    v[0][q] = nk;
#pragma unroll
    for (int r = 1; r < ROWS; ++r) {
      v[r][q] = sel ? rem[r * B + l] : sm[r * B + l];
    }
  }
  cluster.sync();  // no block writes before every block has read
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    const int l = threadIdx.x + q * T;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sm[r * B + l] = v[r][q];
  }
  __syncthreads();
}

// A cluster launch: block blockIdx.x holds keys [blockIdx.x * 2^b, + 2^b)
// of every row, its keys flipped for the level it is at; the cluster holds
// 2^span keys.
template <int ROWS>
__global__ void __launch_bounds__(max_threads(ROWS))
cluster_kernel(int32_t* __restrict__ mat, long long n, int c_log, int b,
               int k_lo, int k_hi, int j_top) {
    extern __shared__ int4 smem4[];
  int32_t* sm = reinterpret_cast<int32_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int B = 1 << b;
  const int T = B >> kElemLog;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> kLaneLog;
  const long long base = static_cast<long long>(blockIdx.x) << b;
  // The in-slab index of the block's first key (c_log <= 30).
  const unsigned ib0 = static_cast<unsigned>(base & ((1ll << c_log) - 1));

  for (int r = 0; r < ROWS; ++r) {
    const int4* src = reinterpret_cast<const int4*>(mat + r * n + base);
    int4* dst = smem4 + r * (B >> 2);
    for (int i = threadIdx.x; i < (B >> 2); i += T) {
      int4 x = src[i];
      if (r == 0) {
        const unsigned i0 = ib0 + 4 * i;
        x.x ^= flip(i0, k_lo);
        x.y ^= flip(i0 + 1, k_lo);
        x.z ^= flip(i0 + 2, k_lo);
        x.w ^= flip(i0 + 3, k_lo);
      }
      dst[i] = x;
    }
  }
  __syncthreads();

  int32_t v[ROWS][kElems];
  int lo = -1;  // the phase's register bits [lo, lo + 5); -1: none loaded
  int l0 = 0;
  for (int k = k_lo; k <= k_hi; ++k) {
    if (k > k_lo) {
      // The last stage of level k - 1 (j = 0) left the keys in registers.
#pragma unroll
      for (int q = 0; q < kElems; ++q) {
        const unsigned i = ib0 | l0 | (static_cast<unsigned>(q) << lo);
        v[0][q] ^= flip(i, k - 1) ^ flip(i, k);
      }
    }
    for (int j = min(k - 1, j_top); j >= 0; --j) {
      if (j >= b) {
        if (lo >= 0) store_phase<ROWS>(sm, B, l0, lo, v);
        lo = -1;
        cross_stage<ROWS>(cluster, sm, B, T, ib0, b, j, v);
        continue;
      }
      if (lo < 0 || !(j < kLaneLog || (j >= lo && j < lo + kElemLog))) {
        if (lo >= 0) {
          store_phase<ROWS>(sm, B, l0, lo, v);
          __syncthreads();
        }
        lo = min(max(kLaneLog, j - kElemLog + 1), b - kElemLog);
        l0 = phase_base(lo, lane, warp);
        load_phase<ROWS>(sm, B, l0, lo, v);
      }
      if (j < kLaneLog) {
        shfl_stage<ROWS>(v, j, lane);
      } else {
        reg_stage_at<ROWS>(j - lo, v);
      }
    }
  }
  if (lo >= 0) store_phase<ROWS>(sm, B, l0, lo, v);
  __syncthreads();
  for (int r = 0; r < ROWS; ++r) {
    int4* dst = reinterpret_cast<int4*>(mat + r * n + base);
    const int4* src = smem4 + r * (B >> 2);
    for (int i = threadIdx.x; i < (B >> 2); i += T) {
      int4 x = src[i];
      if (r == 0) {
        const unsigned i0 = ib0 + 4 * i;
        x.x ^= flip(i0, k_hi);
        x.y ^= flip(i0 + 1, k_hi);
        x.z ^= flip(i0 + 2, k_hi);
        x.w ^= flip(i0 + 3, k_hi);
      }
      dst[i] = x;
    }
  }
  cluster.sync();  // no block exits while another may read its memory
}

// A global pass: thread p holds the 2^MS keys of one group, the indices
// that differ only in bits j_lo .. j_lo + MS - 1; neighbouring threads
// hold neighbouring groups, so every load is coalesced.
template <int ROWS, int MS>
__global__ void __launch_bounds__(kGlobalThreads)
global_kernel(int32_t* __restrict__ mat, long long n, long long slab_mask,
              int k, int j_lo) {
  constexpr int G = 1 << MS;
  const long long p =
      static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (p >= (n >> MS)) return;
  const long long i0 =
      ((p >> j_lo) << (j_lo + MS)) | (p & ((1ll << j_lo) - 1));
  // Bit k of the in-slab index: above the group's bits, one for all.
  const int32_t m = flip(static_cast<unsigned>(i0 & slab_mask), k);
  int32_t v[ROWS][G];
#pragma unroll
  for (int t = 0; t < G; ++t) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      v[r][t] = mat[r * n + i0 + (static_cast<long long>(t) << j_lo)];
    }
    v[0][t] ^= m;
  }
#pragma unroll
  for (int s = MS - 1; s >= 0; --s) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      if (t & (1 << s)) continue;
      const int t2 = t | (1 << s);
      const int32_t a = v[0][t], c = v[0][t2];
      const bool sw = c < a;
      v[0][t] = min(a, c);
      v[0][t2] = max(a, c);
#pragma unroll
      for (int r = 1; r < ROWS; ++r) {
        const int32_t x = v[r][t], y = v[r][t2];
        v[r][t] = sw ? y : x;
        v[r][t2] = sw ? x : y;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < G; ++t) {
    v[0][t] ^= m;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mat[r * n + i0 + (static_cast<long long>(t) << j_lo)] = v[r][t];
    }
  }
}

template <int ROWS>
cudaError_t cluster_config(int span, int b, long long n, cudaStream_t s,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int smem = ROWS * (4 << b);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(n >> b));
  cfg->blockDim = dim3(1u << (b - kElemLog));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << (span - b);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int ROWS>
cudaError_t launch_cluster(int32_t* m, long long n, int c_log, int span, int b,
                           const int* step, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<ROWS>(span, b, n, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cluster_kernel<ROWS>, m, n, c_log, b,
                           step[1], step[2], step[3]);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int ROWS, int MS>
cudaError_t launch_pass(int32_t* m, long long n, long long slab_mask, int k,
                        int j_lo, cudaStream_t s) {
  if constexpr (MS <= global_stages(ROWS)) {
    const dim3 grid(static_cast<unsigned>(
        ((n >> MS) + kGlobalThreads - 1) / kGlobalThreads));
    global_kernel<ROWS, MS><<<grid, kGlobalThreads, 0, s>>>(m, n, slab_mask,
                                                           k, j_lo);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <int ROWS>
cudaError_t launch_global(int32_t* m, long long n, int c_log, const int* step,
                          cudaStream_t s) {
  const int k = step[1], j_hi = step[2], j_lo = step[3];
  const int ms = j_hi - j_lo + 1;
  const long long slab_mask = (1ll << c_log) - 1;
  switch (ms) {
    case 1: return launch_pass<ROWS, 1>(m, n, slab_mask, k, j_lo, s);
    case 2: return launch_pass<ROWS, 2>(m, n, slab_mask, k, j_lo, s);
    case 3: return launch_pass<ROWS, 3>(m, n, slab_mask, k, j_lo, s);
    case 4: return launch_pass<ROWS, 4>(m, n, slab_mask, k, j_lo, s);
    case 5: return launch_pass<ROWS, 5>(m, n, slab_mask, k, j_lo, s);
    case 6: return launch_pass<ROWS, 6>(m, n, slab_mask, k, j_lo, s);
    default: return launch_pass<ROWS, 7>(m, n, slab_mask, k, j_lo, s);
  }
}

// Launches the plan's steps in order, counting in ``*launched`` the
// launches that the runtime accepted.
template <int ROWS>
cudaError_t run_plan(int32_t* m, long long n, int c_log, int span, int b,
                     const int* plan, int n_steps, cudaStream_t s,
                     int* launched) {
  for (int i = 0; i < n_steps; ++i) {
    const int* step = plan + 4 * i;
    const cudaError_t err =
        step[0] == 0 ? launch_cluster<ROWS>(m, n, c_log, span, b, step, s)
                     : launch_global<ROWS>(m, n, c_log, step, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

template <int ROWS>
cudaError_t max_clusters(int span, int b, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      cluster_config<ROWS>(span, b, 1ll << span, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, cluster_kernel<ROWS>, &cfg);
}

bool valid_shape(int rows, int c_log, int span, int b) {
  return c_log >= 10 && c_log <= 30 && span >= 1 && span <= c_log &&
         b <= span && b >= kLaneLog + kElemLog && b <= block_log_max(rows) &&
         span - b <= kClusterLog;
}

bool valid_step(const int* st, int rows, int c_log, int span) {
  if (st[0] == 0) {
    return st[1] >= 1 && st[1] <= st[2] && st[2] <= c_log && st[3] >= 0 &&
           st[3] < span;
  }
  return st[0] == 1 && st[1] <= c_log && st[2] < st[1] && st[3] >= span &&
         st[3] <= st[2] && st[2] - st[3] < global_stages(rows);
}

}  // namespace

// C entry point (ctypes). ``mat``: device pointer to the (1 + n_payload, n)
// int32 matrix, 16-byte aligned, n a multiple of 2^c_log; ``span``: keys a
// cluster holds, log2 (<= c_log); ``b``: keys a block holds, log2;
// ``plan``: host array of ``n_steps`` int32 quadruples (see the header);
// ``stream``: the caller's CUDA stream; ``launched``: out, the launches
// made, one a step; returns the first error (a refused launch
// included), else cudaSuccess; allocates nothing, does not sync.
extern "C" int slab_sort(void* mat, int n_payload, long long n, int c_log,
                         int span, int b, const int* plan, int n_steps,
                         void* stream, int* launched) {
  *launched = 0;
  if (n <= 0) return 0;
  if (n_payload < 0 || n_payload > kMaxPayload) return cudaErrorInvalidValue;
  const int rows = 1 + n_payload;
  if (!valid_shape(rows, c_log, span, b)) return cudaErrorInvalidValue;
  if (n % (1ll << c_log) != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(mat) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  for (int i = 0; i < n_steps; ++i) {
    if (!valid_step(plan + 4 * i, rows, c_log, span)) {
      return cudaErrorInvalidValue;
    }
  }
  auto* m = static_cast<int32_t*>(mat);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 1:
      err = run_plan<1>(m, n, c_log, span, b, plan, n_steps, s, launched);
      break;
    case 2:
      err = run_plan<2>(m, n, c_log, span, b, plan, n_steps, s, launched);
      break;
    case 3:
      err = run_plan<3>(m, n, c_log, span, b, plan, n_steps, s, launched);
      break;
    case 4:
      err = run_plan<4>(m, n, c_log, span, b, plan, n_steps, s, launched);
      break;
    default:
      err = run_plan<5>(m, n, c_log, span, b, plan, n_steps, s, launched);
      break;
  }
  return static_cast<int>(err);
}

// cudaOccupancyMaxActiveClusters for the cluster launch of this shape,
// into ``*out``; returns the CUDA error.
extern "C" int slab_sort_max_clusters(int n_payload, int span, int b,
                                      int* out) {
  const int rows = 1 + n_payload;
  if (n_payload < 0 || n_payload > kMaxPayload ||
      !valid_shape(rows, span, span, b)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (rows) {
    case 1: err = max_clusters<1>(span, b, out); break;
    case 2: err = max_clusters<2>(span, b, out); break;
    case 3: err = max_clusters<3>(span, b, out); break;
    case 4: err = max_clusters<4>(span, b, out); break;
    default: err = max_clusters<5>(span, b, out); break;
  }
  return static_cast<int>(err);
}
