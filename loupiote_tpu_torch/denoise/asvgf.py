"""A-SVGF denoiser: temporal reprojection, a-trous wavelet, compositing
(counterpart of ``loupiote_tpu/denoise/asvgf.py``).

Moment-based variance guides an edge-aware wavelet filter over
demodulated illumination, and compositing re-multiplies the albedo.
Previous-frame state comes in and new state goes out; nothing is updated
in place. ``temporal`` (demodulation, reprojection, variance) and
``denoise`` (that, then the a-trous iterations) launch the kernels of
``csrc/asvgf.cu`` for CUDA tensors, one for the temporal pass and one an
iteration, and run the plain torch twins below over (H, W, C) tensors,
the reference's layout, for CPU tensors; there is no fallback from one to
the other. The reference leaves this part to XLA, which fuses it; as
eager torch ops on the card the twins take ~7,900 launches a frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build, spans
from .._build import check_args

# Temporal blend floor: history is capped so fresh samples always count.
ALPHA_MIN = 0.05
MAX_HISTORY = 32.0
# Edge-stopping parameters (SVGF defaults).
SIGMA_NORMAL = 64.0
SIGMA_DEPTH = 1.0
SIGMA_LUM = 4.0


class TemporalOut(NamedTuple):
    illum: torch.Tensor  # (H, W, 3) integrated illumination
    moments: torch.Tensor  # (H, W, 2) integrated (mu1, mu2) of luminance
    history: torch.Tensor  # (H, W) float32 history length
    variance: torch.Tensor  # (H, W) luminance variance estimate


def _luminance(rgb):
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])


def demodulate(radiance, albedo):
    """Split illumination from surface albedo for filtering."""
    return radiance / torch.clamp_min(albedo, 1e-3)


def modulate(illum, albedo):
    """Re-apply the albedo (compositing)."""
    return illum * torch.clamp_min(albedo, 1e-3)


def temporal_reproject(curr_illum, motion, curr_normal, curr_depth,
                       curr_mesh, prev_normal, prev_depth, prev_mesh,
                       prev_illum, prev_moments, prev_history) -> TemporalOut:
    """Reproject the previous frame's integrated illumination and moments
    through the motion vectors with a validity-checked bilinear tap (mesh
    id, depth and normal consistency), then blend the current sample in
    with an alpha driven by history length."""
    h, w = curr_depth.shape
    dev = curr_depth.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # motion is uv_prev - uv_curr in [0,1] units (render/renderer.py).
    px = xx + motion[..., 0] * w
    py = yy + motion[..., 1] * h
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0

    # Everything reprojection reads, as one (H*W, 11) table: one row
    # gather per tap.
    prev_pack = torch.cat([
        prev_illum, prev_moments, prev_history[..., None], prev_normal,
        prev_depth[..., None], prev_mesh.to(torch.float32)[..., None],
    ], dim=-1).reshape(h * w, 11)
    curr_mesh_f = curr_mesh.to(torch.float32)

    illum_acc = torch.zeros_like(curr_illum)
    mom_acc = torch.zeros(curr_depth.shape + (2,), device=dev)
    hist_acc = torch.zeros_like(curr_depth)
    w_acc = torch.zeros_like(curr_depth)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            wgt = (fx if dx == 1 else 1.0 - fx) * (fy if dy == 1 else 1.0 - fy)
            in_bounds = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi_c = torch.clamp(xi.to(torch.int64), 0, w - 1)
            yi_c = torch.clamp(yi.to(torch.int64), 0, h - 1)
            tap = prev_pack[yi_c * w + xi_c]  # (H, W, 11)
            p_depth = tap[..., 9]
            same_mesh = tap[..., 10] == curr_mesh_f
            depth_ok = (p_depth - curr_depth).abs() <= (
                0.1 * torch.clamp_min(torch.maximum(p_depth, curr_depth),
                                      1e-3))
            normal_ok = (tap[..., 6:9] * curr_normal).sum(-1) > 0.9
            valid = (in_bounds & same_mesh & depth_ok & normal_ok
                     & (curr_mesh >= 0))
            wv = torch.where(valid, wgt, 0.0)
            illum_acc = illum_acc + tap[..., 0:3] * wv[..., None]
            mom_acc = mom_acc + tap[..., 3:5] * wv[..., None]
            hist_acc = hist_acc + tap[..., 5] * wv
            w_acc = w_acc + wv

    reproj_ok = w_acc > 1e-3
    inv_w = 1.0 / torch.clamp_min(w_acc, 1e-3)
    prev_i = illum_acc * inv_w[..., None]
    prev_m = mom_acc * inv_w[..., None]
    prev_h = hist_acc * inv_w

    history = torch.where(reproj_ok,
                          torch.clamp_max(prev_h + 1.0, MAX_HISTORY), 1.0)
    alpha = torch.clamp_min(1.0 / history, ALPHA_MIN)
    lum = _luminance(curr_illum)
    curr_m = torch.stack([lum, lum * lum], dim=-1)
    illum = torch.where(reproj_ok[..., None],
                        prev_i + (curr_illum - prev_i) * alpha[..., None],
                        curr_illum)
    moments = torch.where(reproj_ok[..., None],
                          prev_m + (curr_m - prev_m) * alpha[..., None],
                          curr_m)
    var_temporal = torch.clamp_min(moments[..., 1] - moments[..., 0] ** 2,
                                   0.0)
    # Spatial variance for young pixels (standard SVGF).
    variance = torch.where(history < 4.0, _spatial_variance(lum),
                           var_temporal)
    return TemporalOut(illum, moments, history, variance)


def _shift(img, dy: int, dx: int):
    """Edge-clamped shift, ``out[y, x] = img[clamp(y - dy), clamp(x - dx)]``:
    what the reference's ``jnp.pad(mode="edge")`` followed by its crop
    gives (it pads ``dy`` rows before the image and crops from the top).
    The taps' order, and so the order of every sum, is the reference's.
    Clamped indices stand in for the pad, which ``F.pad`` would take only
    in (N, C, H, W) layout."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    iy = torch.clamp(torch.arange(h, device=dev) - dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=dev) - dx, 0, w - 1)
    return img.index_select(0, iy).index_select(1, ix)


def _spatial_variance(lum):
    """3x3 mean/second-moment luminance variance."""
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _shift(lum, dy, dx)
            s1 = s1 + v
            s2 = s2 + v * v
    m1 = s1 / 9.0
    m2 = s2 / 9.0
    return torch.clamp_min(m2 - m1 * m1, 0.0)


_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_iteration(illum, variance, normal, depth, mesh, step: int):
    """One edge-aware 5x5 a-trous wavelet iteration."""
    lum_p = _luminance(illum)
    # Variance prefilter (3x3 gaussian) for stable edge weights.
    gvar = _gauss3(variance)
    sigma_l_den = SIGMA_LUM * torch.sqrt(torch.clamp_min(gvar, 0.0)) + 1e-4
    mesh_f = mesh.to(torch.float32)
    depth_den = SIGMA_DEPTH * torch.clamp_min(depth, 1e-3) * step + 1e-4

    acc_i = torch.zeros_like(illum)
    acc_v = torch.zeros_like(variance)
    acc_w = torch.zeros_like(variance)
    for ky, wy in enumerate(_B3):
        for kx, wx in enumerate(_B3):
            dy = (ky - 2) * step
            dx = (kx - 2) * step
            k = wy * wx
            q_illum = _shift(illum, dy, dx)
            q_var = _shift(variance, dy, dx)
            q_n = _shift(normal, dy, dx)
            q_z = _shift(depth, dy, dx)
            q_m = _shift(mesh_f, dy, dx)
            q_l = _luminance(q_illum)
            w_n = torch.clamp_min((q_n * normal).sum(-1), 0.0) ** SIGMA_NORMAL
            w_z = torch.exp(-(q_z - depth).abs() / depth_den)
            w_l = torch.exp(-(q_l - lum_p).abs() / sigma_l_den)
            w_m = (q_m == mesh_f).to(torch.float32)
            wgt = k * w_n * w_z * w_l * w_m
            acc_i = acc_i + q_illum * wgt[..., None]
            acc_v = acc_v + q_var * wgt * wgt
            acc_w = acc_w + wgt
    inv = 1.0 / torch.clamp_min(acc_w, 1e-6)
    return acc_i * inv[..., None], acc_v * inv * inv


def _gauss3(x):
    k = (0.25, 0.5, 0.25)
    out = torch.zeros_like(x)
    for ky, wy in enumerate(k):
        for kx, wx in enumerate(k):
            out = out + _shift(x, ky - 1, kx - 1) * (wy * wx)
    return out


def atrous_filter(illum, variance, normal, depth, mesh, iterations: int = 4):
    """An even number of a-trous iterations with dilation 1, 2, 4, ..."""
    if iterations % 2:
        raise ValueError("the a-trous filter needs an even iteration count")
    out_i, out_v = illum, variance
    for i in range(iterations):
        out_i, out_v = atrous_iteration(out_i, out_v, normal, depth, mesh,
                                        step=1 << i)
    return out_i


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU tensor (the
    twins); raises for any other device. Counts the path taken,
    ``("asvgf", "cuda" | "plain")``, while a recording is on."""
    card = _build.on_card(x, "A-SVGF")
    spans.count("asvgf", "cuda" if card else "plain")
    return card


def _temporal_cuda(radiance, albedo, motion, normal, depth, mesh,
                   prev_normal, prev_depth, prev_mesh, prev_illum,
                   prev_moments, prev_history):
    """``asvgf_temporal`` on CUDA tensors: (TemporalOut, temporal_rgb)."""
    if depth.dim() != 2:
        raise ValueError(f"curr_depth: need shape (H, W), got "
                         f"{tuple(depth.shape)}")
    h, w = depth.shape
    dev = depth.device
    f32, i32 = torch.float32, torch.int32
    args = (("sample_radiance", radiance, f32, (h, w, 3)),
            ("albedo", albedo, f32, (h, w, 3)),
            ("motion", motion, f32, (h, w, 2)),
            ("curr_normal", normal, f32, (h, w, 3)),
            ("curr_depth", depth, f32, (h, w)),
            ("curr_mesh", mesh, i32, (h, w)),
            ("prev_normal", prev_normal, f32, (h, w, 3)),
            ("prev_depth", prev_depth, f32, (h, w)),
            ("prev_mesh", prev_mesh, i32, (h, w)),
            ("prev_illum", prev_illum, f32, (h, w, 3)),
            ("prev_moments", prev_moments, f32, (h, w, 2)),
            ("prev_history", prev_history, f32, (h, w)))
    check_args(dev, args)
    t = TemporalOut(torch.empty((h, w, 3), dtype=f32, device=dev),
                    torch.empty((h, w, 2), dtype=f32, device=dev),
                    torch.empty((h, w), dtype=f32, device=dev),
                    torch.empty((h, w), dtype=f32, device=dev))
    rgb = torch.empty((h, w, 3), dtype=f32, device=dev)
    _build.launch("asvgf", "asvgf_temporal", "17p2is",
                  *(x for _, x, _, _ in args), *t, rgb, h, w)
    return t, rgb


def _atrous_step(illum, variance, normal, depth, mesh, step: int,
                 albedo=None):
    """One ``asvgf_atrous`` launch on CUDA tensors: ``atrous_iteration``'s
    (illum, variance) at dilation ``step``, or with ``albedo`` the
    displayed image ``modulate(illum, albedo)`` and None."""
    h, w = depth.shape
    dev = depth.device
    f32 = torch.float32
    check_args(dev, (("illum", illum, f32, (h, w, 3)),
                     ("variance", variance, f32, (h, w)),
                     ("curr_normal", normal, f32, (h, w, 3)),
                     ("curr_depth", depth, f32, (h, w)),
                     ("curr_mesh", mesh, torch.int32, (h, w))))
    if albedo is not None:
        check_args(dev, (("albedo", albedo, f32, (h, w, 3)),))
    out_i = torch.empty_like(illum)
    out_v = None if albedo is not None else torch.empty_like(variance)
    _build.launch("asvgf", "asvgf_atrous", "8p3is", illum, variance, normal,
                  depth, mesh, albedo, out_i, out_v, h, w, step)
    return out_i, out_v


def temporal(sample_radiance, albedo, motion, curr_normal, curr_depth,
             curr_mesh, prev_normal, prev_depth, prev_mesh, prev_illum,
             prev_moments, prev_history):
    """The temporal pass of one A-SVGF frame: ``demodulate`` then
    ``temporal_reproject``. Returns (TemporalOut, temporal_rgb), the
    latter ``modulate(illum, albedo)``: one kernel launch for CUDA
    tensors, ``temporal_plain`` for CPU tensors."""
    args = (sample_radiance, albedo, motion, curr_normal, curr_depth,
            curr_mesh, prev_normal, prev_depth, prev_mesh, prev_illum,
            prev_moments, prev_history)
    fn = _temporal_cuda if _on_card(curr_depth) else temporal_plain
    return fn(*args)


def temporal_plain(sample_radiance, albedo, *rest):
    """``temporal``'s plain twin."""
    t = temporal_reproject(demodulate(sample_radiance, albedo), *rest)
    return t, modulate(t.illum, albedo)


def denoise(sample_radiance, albedo, motion, curr_normal, curr_depth,
            curr_mesh, prev_normal, prev_depth, prev_mesh, prev_illum,
            prev_moments, prev_history, iterations: int = 4):
    """One A-SVGF frame: the temporal pass, then ``iterations`` (even)
    a-trous iterations with dilation 1, 2, 4, ... Returns (denoised_rgb,
    TemporalOut, temporal_rgb); the TemporalOut is the state to keep for
    the next frame. For CUDA tensors 1 + ``iterations`` kernel launches,
    each iteration's output in buffers of its own; for CPU tensors
    ``denoise_plain``."""
    if iterations % 2:
        raise ValueError("the a-trous filter needs an even iteration count")
    args = (sample_radiance, albedo, motion, curr_normal, curr_depth,
            curr_mesh, prev_normal, prev_depth, prev_mesh, prev_illum,
            prev_moments, prev_history)
    if not _on_card(curr_depth):
        return denoise_plain(*args, iterations=iterations)
    t, rgb = _temporal_cuda(*args)
    out_i, out_v = t.illum, t.variance
    for i in range(iterations):
        last = i == iterations - 1
        out_i, out_v = _atrous_step(out_i, out_v, curr_normal, curr_depth,
                                    curr_mesh, 1 << i,
                                    albedo if last else None)
    return (out_i if iterations else rgb), t, rgb


def denoise_plain(sample_radiance, albedo, motion, curr_normal, curr_depth,
                  curr_mesh, prev_normal, prev_depth, prev_mesh, prev_illum,
                  prev_moments, prev_history, iterations: int = 4):
    """``denoise``'s plain twin."""
    t, rgb = temporal_plain(sample_radiance, albedo, motion, curr_normal,
                            curr_depth, curr_mesh, prev_normal, prev_depth,
                            prev_mesh, prev_illum, prev_moments,
                            prev_history)
    filtered = atrous_filter(t.illum, t.variance, curr_normal, curr_depth,
                             curr_mesh, iterations)
    return modulate(filtered, albedo), t, rgb
