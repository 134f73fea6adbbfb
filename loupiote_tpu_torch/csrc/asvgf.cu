// A-SVGF as two kernels, one thread a pixel: asvgf_temporal (demodulation,
// temporal reprojection, moments and variance, the temporal pass's image)
// and asvgf_atrous (one edge-aware 5x5 a-trous iteration; the last one
// also re-applies the albedo).
//
// Replaces no TPU kernel: the reference (loupiote_tpu/denoise/asvgf.py)
// leaves A-SVGF to XLA, which fuses it. Its plain torch twins,
// loupiote_tpu_torch/denoise/asvgf.py (demodulate, temporal_reproject,
// _spatial_variance, _gauss3, atrous_iteration, modulate), ran as eager
// torch on the card: ~7,900 launches a 640x360 frame (about 40 a tap of
// each of the 25 taps of each of 4 iterations), 15.2 ms of device time and
// ~134 ms of the host's issue in a ~250 ms viewer frame, the device idle
// ~91% of it. These kernels take that to 1 + iterations launches.
//
// What bounds them on an H100: a 640x360 frame's inputs and outputs are
// 148 bytes a pixel, ~34 MB (~10 us of device-memory bytes at 3.35 TB/s),
// and an iteration's working set (~12 MB) lives in the 50 MB L2; each
// pixel's 25 taps of each iteration re-read neighbours that the warp's
// other lanes read too, from L1 / L2. The work is the
// taps' arithmetic: per tap one powf (the normal weight's 64th power),
// two expf and two IEEE divisions, ~100 powf / expf a pixel a frame. The
// design keeps it one pass a kernel with no shared-memory tile: blocks of
// 32 x 8 pixels, so a tap's reads of a warp are one row segment. On the
// card the five launches take ~0.21 ms a 640x360 frame against a bound of
// ~0.014 ms (PERF.md), in a viewer frame of ~77 ms that the host's issue
// paces with the device idle ~82%: a halo tile could save at most that
// 0.2 ms, which the frame would not show.
//
// Arithmetic: each line mirrors the twin's torch op, in float32, with
// every product separately rounded (--fmad=false, as torch's one-op
// kernels round), IEEE division and sqrt, expf / powf as torch's CUDA
// kernels call them, torch's NaN-propagating clamp_min / clamp_max /
// maximum, and each sum in the twin's order. Two of torch's CUDA
// kernels differ from the formula as written:
//  - `x / 9.0` by a Python scalar is `x * (1.0f / 9.0f)` (torch's
//    div_true multiplies by the scalar's float reciprocal);
//  - `(a * b).sum(-1)` over 3 components is reduced by two threads, one
//    holding components 0 and 2 and one component 1: (a0b0 + a2b2) + a1b1.
// So the kernels agree with the twins bit for bit on the card.
//
// Build: nvcc -O3 -std=c++17 --fmad=false -gencode arch=compute_90a,code=sm_90a
// (loupiote_tpu_torch/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

constexpr float kAlphaMin = 0.05f;  // asvgf.py: ALPHA_MIN
constexpr float kMaxHistory = 32.0f;  // MAX_HISTORY
constexpr float kSigmaNormal = 64.0f;  // SIGMA_NORMAL
constexpr float kSigmaDepth = 1.0f;  // SIGMA_DEPTH
constexpr float kSigmaLum = 4.0f;  // SIGMA_LUM

// torch.clamp_min / clamp_max / maximum on the card: NaN propagates.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// _luminance: (0.2126 r + 0.7152 g) + 0.0722 b.
__device__ __forceinline__ float luminance(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// (a * b).sum(-1) over 3 components, in the order of torch's reduction on
// the card (see the note at the top).
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  const float p0 = a[0] * b[0];
  const float p1 = a[1] * b[1];
  const float p2 = a[2] * b[2];
  return (p0 + p2) + p1;
}

// demodulate's luminance at pixel q: radiance / clamp_min(albedo, 1e-3).
__device__ __forceinline__ float demod_lum(const float* radiance,
                                           const float* albedo, size_t q) {
  const float* r = radiance + 3 * q;
  const float* a = albedo + 3 * q;
  return luminance(r[0] / clamp_min(a[0], 1e-3f),
                   r[1] / clamp_min(a[1], 1e-3f),
                   r[2] / clamp_min(a[2], 1e-3f));
}

// _spatial_variance at (y, x): the 3x3 edge-clamped window of the
// demodulated luminance, rows y+1, y, y-1 (the twin's dy = -1, 0, 1).
__device__ float spatial_variance(const float* radiance, const float* albedo,
                                  int y, int x, int h, int w) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = clamp_index(y - dy, h);
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = clamp_index(x - dx, w);
      const float v = demod_lum(radiance, albedo,
                                static_cast<size_t>(yy) * w + xx);
      s1 = s1 + v;
      s2 = s2 + v * v;
    }
  }
  const float m1 = s1 * (1.0f / 9.0f);
  const float m2 = s2 * (1.0f / 9.0f);
  return clamp_min(m2 - m1 * m1, 0.0f);
}

// demodulate + temporal_reproject + modulate(illum, albedo) at one pixel.
__global__ void __launch_bounds__(kBlockX * kBlockY)
temporal_kernel(const float* __restrict__ radiance,
                const float* __restrict__ albedo,
                const float* __restrict__ motion,
                const float* __restrict__ normal,
                const float* __restrict__ depth,
                const int32_t* __restrict__ mesh,
                const float* __restrict__ prev_normal,
                const float* __restrict__ prev_depth,
                const int32_t* __restrict__ prev_mesh,
                const float* __restrict__ prev_illum,
                const float* __restrict__ prev_moments,
                const float* __restrict__ prev_history,
                float* __restrict__ illum_out, float* __restrict__ moments_out,
                float* __restrict__ history_out,
                float* __restrict__ variance_out, float* __restrict__ rgb_out,
                int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t p = static_cast<size_t>(y) * w + x;

  float alb[3], curr[3], n[3];
  for (int c = 0; c < 3; ++c) {
    alb[c] = clamp_min(albedo[3 * p + c], 1e-3f);
    curr[c] = radiance[3 * p + c] / alb[c];
    n[c] = normal[3 * p + c];
  }
  const float fw = static_cast<float>(w), fh = static_cast<float>(h);
  const float px = static_cast<float>(x) + motion[2 * p] * fw;
  const float py = static_cast<float>(y) + motion[2 * p + 1] * fh;
  const float x0 = floorf(px), y0 = floorf(py);
  const float fx = px - x0, fy = py - y0;
  const float z = depth[p];
  const int32_t m = mesh[p];
  const float m_f = static_cast<float>(m);

  float illum_acc[3] = {0.0f, 0.0f, 0.0f}, mom_acc[2] = {0.0f, 0.0f};
  float hist_acc = 0.0f, w_acc = 0.0f;
  for (int dy = 0; dy <= 1; ++dy) {
    for (int dx = 0; dx <= 1; ++dx) {
      const float xi = x0 + static_cast<float>(dx);
      const float yi = y0 + static_cast<float>(dy);
      const float wgt = (dx == 1 ? fx : 1.0f - fx) *
                        (dy == 1 ? fy : 1.0f - fy);
      const bool in_bounds = xi >= 0.0f && xi < fw && yi >= 0.0f && yi < fh;
      const long long xl = static_cast<long long>(xi);
      const long long yl = static_cast<long long>(yi);
      const long long xc = xl < 0 ? 0 : (xl > w - 1 ? w - 1 : xl);
      const long long yc = yl < 0 ? 0 : (yl > h - 1 ? h - 1 : yl);
      const size_t q = static_cast<size_t>(yc * w + xc);
      const float p_depth = prev_depth[q];
      const bool same_mesh = static_cast<float>(prev_mesh[q]) == m_f;
      const bool depth_ok = fabsf(p_depth - z) <=
                            0.1f * clamp_min(maximum(p_depth, z), 1e-3f);
      const bool normal_ok = dot3(prev_normal + 3 * q, n) > 0.9f;
      const bool valid = in_bounds && same_mesh && depth_ok && normal_ok &&
                         m >= 0;
      const float wv = valid ? wgt : 0.0f;
      for (int c = 0; c < 3; ++c) {
        illum_acc[c] = illum_acc[c] + prev_illum[3 * q + c] * wv;
      }
      mom_acc[0] = mom_acc[0] + prev_moments[2 * q] * wv;
      mom_acc[1] = mom_acc[1] + prev_moments[2 * q + 1] * wv;
      hist_acc = hist_acc + prev_history[q] * wv;
      w_acc = w_acc + wv;
    }
  }

  const bool reproj_ok = w_acc > 1e-3f;
  const float inv_w = 1.0f / clamp_min(w_acc, 1e-3f);
  const float prev_h = hist_acc * inv_w;
  const float history =
      reproj_ok ? clamp_max(prev_h + 1.0f, kMaxHistory) : 1.0f;
  const float alpha = clamp_min(1.0f / history, kAlphaMin);
  const float lum = luminance(curr[0], curr[1], curr[2]);
  const float curr_m[2] = {lum, lum * lum};
  for (int c = 0; c < 3; ++c) {
    const float prev_i = illum_acc[c] * inv_w;
    const float out = reproj_ok ? prev_i + (curr[c] - prev_i) * alpha
                                : curr[c];
    illum_out[3 * p + c] = out;
    rgb_out[3 * p + c] = out * alb[c];
  }
  float mom[2];
  for (int k = 0; k < 2; ++k) {
    const float prev_m = mom_acc[k] * inv_w;
    mom[k] = reproj_ok ? prev_m + (curr_m[k] - prev_m) * alpha : curr_m[k];
    moments_out[2 * p + k] = mom[k];
  }
  history_out[p] = history;
  // Spatial variance for young pixels (standard SVGF).
  variance_out[p] =
      history < 4.0f ? spatial_variance(radiance, albedo, y, x, h, w)
                     : clamp_min(mom[1] - mom[0] * mom[0], 0.0f);
}

// atrous_iteration at one pixel, dilation `step`. With `albedo` set (the
// last iteration) it writes modulate(filtered, albedo) to out_illum and no
// variance.
__global__ void __launch_bounds__(kBlockX * kBlockY)
atrous_kernel(const float* __restrict__ illum,
              const float* __restrict__ variance,
              const float* __restrict__ normal,
              const float* __restrict__ depth,
              const int32_t* __restrict__ mesh,
              const float* __restrict__ albedo,
              float* __restrict__ out_illum, float* __restrict__ out_variance,
              int h, int w, int step) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t p = static_cast<size_t>(y) * w + x;
  constexpr float kB3[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f,
                            1.0f / 4.0f, 1.0f / 16.0f};
  constexpr float kG3[3] = {0.25f, 0.5f, 0.25f};

  const float* ip = illum + 3 * p;
  const float lum_p = luminance(ip[0], ip[1], ip[2]);
  // _gauss3 of the variance: the variance prefilter for the edge weights.
  float gvar = 0.0f;
  for (int ky = 0; ky < 3; ++ky) {
    const int yy = clamp_index(y - (ky - 1), h);
    for (int kx = 0; kx < 3; ++kx) {
      const int xx = clamp_index(x - (kx - 1), w);
      gvar = gvar + variance[static_cast<size_t>(yy) * w + xx] *
                        (kG3[ky] * kG3[kx]);
    }
  }
  const float sigma_l_den =
      kSigmaLum * sqrtf(clamp_min(gvar, 0.0f)) + 1e-4f;
  const float z = depth[p];
  const float depth_den = kSigmaDepth * clamp_min(z, 1e-3f) *
                          static_cast<float>(step) + 1e-4f;
  const float m_f = static_cast<float>(mesh[p]);
  const float n[3] = {normal[3 * p], normal[3 * p + 1], normal[3 * p + 2]};

  float acc_i[3] = {0.0f, 0.0f, 0.0f};
  float acc_v = 0.0f, acc_w = 0.0f;
  for (int ky = 0; ky < 5; ++ky) {
    const int yy = clamp_index(y - (ky - 2) * step, h);
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = clamp_index(x - (kx - 2) * step, w);
      const size_t q = static_cast<size_t>(yy) * w + xx;
      const float* qi = illum + 3 * q;
      const float q_l = luminance(qi[0], qi[1], qi[2]);
      const float w_n = powf(clamp_min(dot3(normal + 3 * q, n), 0.0f),
                             kSigmaNormal);
      const float w_z = expf(-fabsf(depth[q] - z) / depth_den);
      const float w_l = expf(-fabsf(q_l - lum_p) / sigma_l_den);
      const float w_m = static_cast<float>(mesh[q]) == m_f ? 1.0f : 0.0f;
      const float wgt = kB3[ky] * kB3[kx] * w_n * w_z * w_l * w_m;
      for (int c = 0; c < 3; ++c) acc_i[c] = acc_i[c] + qi[c] * wgt;
      acc_v = acc_v + variance[q] * wgt * wgt;
      acc_w = acc_w + wgt;
    }
  }
  const float inv = 1.0f / clamp_min(acc_w, 1e-6f);
  if (albedo != nullptr) {
    for (int c = 0; c < 3; ++c) {
      out_illum[3 * p + c] =
          acc_i[c] * inv * clamp_min(albedo[3 * p + c], 1e-3f);
    }
    return;
  }
  for (int c = 0; c < 3; ++c) out_illum[3 * p + c] = acc_i[c] * inv;
  out_variance[p] = acc_v * inv * inv;
}

dim3 grid_of(int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" int asvgf_temporal(
    const void* radiance, const void* albedo, const void* motion,
    const void* normal, const void* depth, const void* mesh,
    const void* prev_normal, const void* prev_depth, const void* prev_mesh,
    const void* prev_illum, const void* prev_moments,
    const void* prev_history, void* illum, void* moments, void* history,
    void* variance, void* rgb, int height, int width, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  temporal_kernel<<<grid_of(height, width), dim3(kBlockX, kBlockY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(radiance), static_cast<const float*>(albedo),
      static_cast<const float*>(motion), static_cast<const float*>(normal),
      static_cast<const float*>(depth), static_cast<const int32_t*>(mesh),
      static_cast<const float*>(prev_normal),
      static_cast<const float*>(prev_depth),
      static_cast<const int32_t*>(prev_mesh),
      static_cast<const float*>(prev_illum),
      static_cast<const float*>(prev_moments),
      static_cast<const float*>(prev_history), static_cast<float*>(illum),
      static_cast<float*>(moments), static_cast<float*>(history),
      static_cast<float*>(variance), static_cast<float*>(rgb), height, width);
  return static_cast<int>(cudaGetLastError());
}

// One a-trous iteration at dilation `step`; `albedo` null except in the
// last iteration, which writes the displayed image to `out_illum`.
extern "C" int asvgf_atrous(const void* illum, const void* variance,
                            const void* normal, const void* depth,
                            const void* mesh, const void* albedo,
                            void* out_illum, void* out_variance, int height,
                            int width, int step, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  if (step < 1) return static_cast<int>(cudaErrorInvalidValue);
  atrous_kernel<<<grid_of(height, width), dim3(kBlockX, kBlockY), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(illum), static_cast<const float*>(variance),
      static_cast<const float*>(normal), static_cast<const float*>(depth),
      static_cast<const int32_t*>(mesh), static_cast<const float*>(albedo),
      static_cast<float*>(out_illum), static_cast<float*>(out_variance),
      height, width, step);
  return static_cast<int>(cudaGetLastError());
}
