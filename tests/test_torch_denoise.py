"""The port's A-SVGF denoiser (loupiote_tpu_torch/denoise/asvgf.py) against
the reference's, function by function, on the same random G-buffers.

The inputs are ``torch_port_helpers.asvgf_frame``'s, made with numpy from
a seed: mesh ids in blocks (edges for the mesh test), normals and depths
piecewise smooth with jumps at the block edges, motion vectors that send
some bilinear taps past the image border, and a previous frame's state.

Tolerance: the shifts are exact; everything else within 1e-5 relative
(atol 1e-6). Both sides evaluate exp and a 64th power in float32 with
their own libraries, and XLA sums the 3-component dot products in its own
order: one ulp in a normal dot becomes about 64 ulp (4e-6) in its weight
through ``** SIGMA_NORMAL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loupiote_tpu.denoise import asvgf as ref
from loupiote_tpu_torch.denoise import asvgf
from torch_port_helpers import asvgf_frame

H, W = 24, 40
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def frame():
    return asvgf_frame(H, W)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, reference):
    np.testing.assert_allclose(port.numpy(), np.asarray(reference), **TOL)


TEMPORAL_ARGS = ("motion", "normal", "depth", "mesh", "prev_normal",
                 "prev_depth", "prev_mesh", "prev_illum", "prev_moments",
                 "prev_history")


def test_demodulate_and_modulate(frame):
    r, a = frame["radiance"], frame["albedo"]
    _close(asvgf.demodulate(_t(r), _t(a)), ref.demodulate(_j(r), _j(a)))
    _close(asvgf.modulate(_t(r), _t(a)), ref.modulate(_j(r), _j(a)))


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -1), (-2, 2), (8, -8),
                                   (16, 16), (-30, 45)])
def test_shift_is_exact(frame, dy, dx):
    for x in (frame["radiance"], frame["depth"]):
        np.testing.assert_array_equal(asvgf._shift(_t(x), dy, dx).numpy(),
                                      np.asarray(ref._shift(_j(x), dy, dx)))


def test_spatial_variance_and_gauss3(frame):
    v = frame["variance"]
    _close(asvgf._spatial_variance(_t(v)), ref._spatial_variance(_j(v)))
    _close(asvgf._gauss3(_t(v)), ref._gauss3(_j(v)))


def test_temporal_reproject(frame):
    illum = asvgf.demodulate(_t(frame["radiance"]), _t(frame["albedo"]))
    out = asvgf.temporal_reproject(illum, *(_t(frame[k])
                                            for k in TEMPORAL_ARGS))
    want = ref.temporal_reproject(_j(illum.numpy()),
                                  *(_j(frame[k]) for k in TEMPORAL_ARGS))
    for name, a, b in zip(ref.TemporalOut._fields, out, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    # Both reprojected and fresh pixels occur.
    hist = out.history.numpy()
    assert (hist == 1).mean() > 0.05 and (hist > 1).mean() > 0.3


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_atrous_iteration(frame, step):
    args = ("normal", "depth", "mesh")
    i, v = asvgf.atrous_iteration(_t(frame["prev_illum"]),
                                  _t(frame["variance"]),
                                  *(_t(frame[k]) for k in args), step=step)
    ri, rv = ref.atrous_iteration(_j(frame["prev_illum"]),
                                  _j(frame["variance"]),
                                  *(_j(frame[k]) for k in args), step=step)
    _close(i, ri)
    _close(v, rv)


def test_atrous_filter_and_denoise(frame):
    args = ("normal", "depth", "mesh")
    _close(asvgf.atrous_filter(_t(frame["prev_illum"]), _t(frame["variance"]),
                               *(_t(frame[k]) for k in args)),
           ref.atrous_filter(_j(frame["prev_illum"]), _j(frame["variance"]),
                             *(_j(frame[k]) for k in args)))
    with pytest.raises(ValueError):
        asvgf.atrous_filter(_t(frame["prev_illum"]), _t(frame["variance"]),
                            *(_t(frame[k]) for k in args), iterations=3)
    lead = (frame["radiance"], frame["albedo"])
    out, t, t_rgb = asvgf.denoise(*(_t(x) for x in lead),
                                  *(_t(frame[k]) for k in TEMPORAL_ARGS))
    rout, rt = ref.denoise(*(_j(x) for x in lead),
                           *(_j(frame[k]) for k in TEMPORAL_ARGS))
    _close(out, rout)
    for a, b in zip(t, rt):
        _close(a, b)
    _close(t_rgb, ref.modulate(rt.illum, _j(frame["albedo"])))
    assert np.isfinite(out.numpy()).all()
