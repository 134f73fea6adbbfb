// E5: the counting regroup's scatter, in two entries.
//
// Both replace the TPU kernel experiments/treelet/regroup.py::_scatter_kernel
// (wrapped by scatter_runs), which copies each slab's key runs to their
// global bases in 256-element DMA chunks, one grid cell a slab in order.
//
//  - scatter_runs: that function as it is, on the run lists the torch glue
//    builds (loupiote_tpu_torch/treelet/regroup.py::block_runs): copy run r
//    < nruns[g] of slab g, data2[g, src : src + len], to out[dst : dst +
//    len]. Twin: treelet/regroup.py::scatter_runs_plain. Used by
//    counting_regroup.
//  - regroup_blocks: the treelet path's whole binning after the slab sort
//    (K4), from the sorted (2, Rp) key/ray matrix to block_regroup's
//    (ray_out, sid_blocks, on). Twin: treelet/regroup.py::
//    regroup_blocks_plain, which is the glue, scatter_runs_plain and the
//    block layout in torch (a batched searchsorted, run lists compacted by
//    three scatters, a repeat_interleave over every output slot, gathers).
//
// No spill. The TPU kernel lets the last chunk of a run write up to 255
// junk elements past its end; that is safe there only because grid cells
// run in order, so a later cell overwrites the spill. GPU blocks run
// concurrently, and such a spill would race with another slab's copy. Both
// entries write each run's elements exactly, and outside the key regions
// write 0, so the result does not depend on the order blocks run in.
//
// What bounds them on an H100: bytes. Each live pair's ray is read once
// and each output slot written once, with no arithmetic to speak of; the
// dump key's pairs and the padding need not be read, and the key runs are
// found by binary searches (5.7 M live pairs of 8.3 M into 8.9 M slots on
// the treelet path's primary wave: ~94 MB, so ~0.028 ms at the H100 SXM's
// 3.35 TB/s; the path entry takes 0.073-0.085 ms on an NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md).
//
// scatter_runs: one block a slab walks its runs in order, its threads
// striding over each run (short runs leave threads idle; 127 slabs fill
// less than one block an SM). The wrapper zero-fills the output.
//
// regroup_blocks needs no atomics, no run lists and no fill, in
// three launches:
//  1. runs: one block a key k, one thread a slab g. Two binary searches in
//     the sorted slab (torch.searchsorted's left side) give the key's run,
//     first[g][k] and its length C; a block scan over slabs gives its
//     exclusive prefix pre[g][k] and the key's total H[k]. Keys >= K (the
//     dump key, the I32_MAX padding) fall in no key's run.
//  2. layout: one block. The tile-aligned regions with the >= chunk gap,
//     their starts (a block scan over keys) and sid_blocks: regions are
//     tile-aligned, so every block of a region takes its key, and the
//     blocks past the last region the last key.
//  3. place: one thread four output slots s of block b: key k = sid[b],
//     offset o = s - starts[k]. Where o < H[k], the slab g that holds
//     element o of key k is the last with pre[g][k] <= o (a binary search
//     over slabs, then a step to the next slab where a run ends inside the
//     four), and ray_out[s] = the ray at g's position first[g][k] + o -
//     pre[g][k], on[s] = 1; else 0 and 0. Each slot is written once, four
//     at a time as one 16-byte store; a run's rays are read in order. The
//     positions are those of the run scatter, so the output is the twin's
//     bit for bit.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kKeyThreads = 128;

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

// Keys below k in the sorted slab row[0 .. n) (torch.searchsorted's left
// side).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ row,
                                           int n, int k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Exclusive scan of x over the block (blockDim.x a multiple of 32, at most
// 1024); *total receives the block's sum. Ends with a barrier, so `part`
// may be reused at once.
__device__ __forceinline__ int block_scan(int x, int32_t* part, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int y = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) y += z;
  }
  if (lane == 31) part[warp] = y;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? part[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += z;
    }
    if (lane < nw) part[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? part[warp - 1] : 0) + y - x;
  *total = part[nw - 1];
  __syncthreads();
  return out;
}

// 1. One block a key k, one thread a slab g: first[g][k], the position of
// the key's run in slab g, its exclusive prefix over slabs pre[g][k], and
// the key's total counts[k].
__global__ void __launch_bounds__(kKeyThreads)
    runs_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ first,
                int32_t* __restrict__ pre, int32_t* __restrict__ counts,
                int G, int K, int c_log) {
  __shared__ int32_t part[32];
  const int k = blockIdx.x;
  int carry = 0;
  for (int g0 = 0; g0 < G; g0 += kKeyThreads) {
    const int g = g0 + threadIdx.x;
    int c = 0;
    if (g < G) {
      const int32_t* row = keys + (static_cast<size_t>(g) << c_log);
      const int lo = lower_bound(row, 1 << c_log, k);
      c = lower_bound(row, 1 << c_log, k + 1) - lo;
      first[static_cast<size_t>(g) * K + k] = lo;
    }
    int total;
    const int ex = block_scan(c, part, &total);
    if (g < G) pre[static_cast<size_t>(g) * K + k] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) counts[k] = carry;
}

// 2. One block: the tile-aligned regions with the >= chunk gap, their
// starts (an exclusive scan over keys) and sid_blocks.
__global__ void __launch_bounds__(kScanThreads)
    layout_kernel(const int32_t* __restrict__ counts,
                  int32_t* __restrict__ starts,
                  int32_t* __restrict__ sid_blocks, int K, int tile,
                  int chunk, int B) {
  __shared__ int32_t part[32];
  int carry = 0;
  for (int k0 = 0; k0 < K; k0 += kScanThreads) {
    const int k = k0 + threadIdx.x;
    const int region =
        k < K ? (counts[k] + chunk + tile - 1) / tile * tile : 0;
    int total;
    const int start = carry + block_scan(region, part, &total);
    if (k < K) {
      starts[k] = start;
      for (int b = start / tile; b < (start + region) / tile && b < B; ++b) {
        sid_blocks[b] = k;
      }
    }
    carry += total;
  }
  for (int b = carry / tile + threadIdx.x; b < B; b += kScanThreads) {
    sid_blocks[b] = K - 1;
  }
}

// 3. One thread four consecutive output slots (tile is a multiple of 4,
// so they share a block and a key), written as one int4 each to ray_out
// and on.
__global__ void __launch_bounds__(kThreads)
    place_kernel(const int32_t* __restrict__ rays,
                  const int32_t* __restrict__ first,
                  const int32_t* __restrict__ pre,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ sid_blocks,
                  int4* __restrict__ ray_out, int4* __restrict__ on, int G,
                  int K, int c_log, int tile, int R, int64_t quads) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int64_t s = 4 * q;
  const int k = __ldg(sid_blocks + s / tile);
  const int o = static_cast<int>(s - __ldg(starts + k));
  const int h = __ldg(counts + k);
  const int hi_ray = R > 0 ? R - 1 : 0;
  int ray[4] = {0, 0, 0, 0}, live[4] = {0, 0, 0, 0};
  if (o < h) {
    int lo = 0, hi = G - 1;  // the last slab g with pre[g][k] <= o
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(pre + static_cast<size_t>(mid) * K + k) <= o) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    int g = lo;
    int base = __ldg(pre + static_cast<size_t>(g) * K + k);
    int next = g + 1 < G ? __ldg(pre + static_cast<size_t>(g + 1) * K + k)
                         : h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = o + j;
      if (oj < h) {
        while (oj >= next) {  // the run ends within the quad
          ++g;
          base = next;
          next = g + 1 < G ? __ldg(pre + static_cast<size_t>(g + 1) * K + k)
                           : h;
        }
        const size_t gk = static_cast<size_t>(g) * K + k;
        const int r = __ldg(rays + (static_cast<size_t>(g) << c_log) +
                            __ldg(first + gk) + oj - base);
        ray[j] = min(max(r, 0), hi_ray);
        live[j] = 1;
      }
    }
  }
  ray_out[q] = make_int4(ray[0], ray[1], ray[2], ray[3]);
  on[q] = make_int4(live[0], live[1], live[2], live[3]);
}

}  // namespace

// C entry points (ctypes). Pointers from tensor.data_ptr(); ``stream``: the
// caller's CUDA stream. Each returns cudaGetLastError() after its launches;
// allocates nothing, does not sync.

// data2 (g, sp), nruns (g,), src/dst/lens (g, maxr) int32, out (out_rows,)
// int32 zeroed by the caller.
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

// mat (2, G << c_log) int32: sorted keys, then the rays. Scratch: first
// and pre (G, K), counts and starts (K,). Out: sid_blocks (B,), ray_out and
// on (B * tile,), 16-byte aligned, tile a multiple of 4. ``made``: the
// launches accepted, counted as each is checked.
extern "C" int regroup_blocks(const void* mat, void* first, void* pre,
                              void* counts, void* starts, void* sid_blocks,
                              void* ray_out, void* on, int G, int K,
                              int c_log, int tile, int chunk, int B, int R,
                              void* stream, int* made) {
  *made = 0;
  if (G <= 0 || K <= 0 || B <= 0 || tile <= 0 || tile % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* keys = static_cast<const int32_t*>(mat);
  const int32_t* rays = keys + (static_cast<size_t>(G) << c_log);
  auto* f = static_cast<int32_t*>(first);
  auto* p = static_cast<int32_t*>(pre);
  auto* h = static_cast<int32_t*>(counts);
  auto* st = static_cast<int32_t*>(starts);
  auto* sid = static_cast<int32_t*>(sid_blocks);
  runs_kernel<<<K, kKeyThreads, 0, s>>>(keys, f, p, h, G, K, c_log);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*made;
  layout_kernel<<<1, kScanThreads, 0, s>>>(h, st, sid, K, tile, chunk, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*made;
  const int64_t quads = static_cast<int64_t>(B) * tile / 4;
  place_kernel<<<static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(rays, f, p, h, st, sid,
                                    static_cast<int4*>(ray_out),
                                    static_cast<int4*>(on), G, K, c_log,
                                    tile, R, quads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*made;
  return 0;
}
