"""A-SVGF's kernels (``csrc/asvgf.cu``: ``asvgf_temporal`` and
``asvgf_atrous``) against their plain torch twins in
``loupiote_tpu_torch/denoise/asvgf.py``.

On the card (the ``card`` cases skip without CUDA; run them there with
``python -m pytest --noconftest tests/test_torch_asvgf_kernel.py``, since
``tests/conftest.py`` imports JAX): each kernel and the whole ``denoise``
bit-equal to the twins on the card, on ``asvgf_frame``'s 24x40 frame
(taps past every border), a ragged 37x53 one, and three consecutive
640x360 frames of the viewer hall with the history carried; the launch
counters; the wrapper's checks. On the CPU: CPU tensors take the twins,
and the checks that come before any launch.
"""

import numpy as np
import pytest
import torch

from loupiote_tpu_torch import spans
from loupiote_tpu_torch import _build
from loupiote_tpu_torch.denoise import asvgf
from torch_port_helpers import asvgf_frame

TEMPORAL_KEYS = ("radiance", "albedo", "motion", "normal", "depth", "mesh",
                 "prev_normal", "prev_depth", "prev_mesh", "prev_illum",
                 "prev_moments", "prev_history")
SIZES = [(24, 40), (37, 53)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the A-SVGF kernels")
    return torch.device("cuda")


def _args(frame, device):
    return tuple(torch.from_numpy(frame[k]).to(device)
                 for k in TEMPORAL_KEYS)


def _bits_equal(name, got, want):
    """Bit equality; on a mismatch, the largest difference in the message."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    same = got.view(torch.int32) == want.view(torch.int32)
    if not bool(same.all()):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"{name}: {int((~same).sum())} of "
                             f"{same.numel()} values differ, largest by "
                             f"{diff!r}")


def _launched():
    """(temporal, a-trous) launches since the last reset_counters()."""
    return (_build.launches["asvgf_temporal", None],
            _build.launches["asvgf_atrous", None])


def _frame_equal(got, want):
    out, t, rgb = got
    w_out, w_t, w_rgb = want
    _bits_equal("denoised", out, w_out)
    for name, a, b in zip(asvgf.TemporalOut._fields, t, w_t):
        _bits_equal(name, a, b)
    _bits_equal("temporal_rgb", rgb, w_rgb)


# -- on the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("h,w", SIZES)
def test_temporal_kernel_equals_twin(card, h, w):
    args = _args(asvgf_frame(h, w), card)
    _build.reset_counters()
    t, rgb = asvgf.temporal(*args)
    assert _launched() == (1, 0)
    want_t, want_rgb = asvgf.temporal_plain(*args)
    for name, a, b in zip(asvgf.TemporalOut._fields, t, want_t):
        _bits_equal(name, a, b)
    _bits_equal("temporal_rgb", rgb, want_rgb)
    hist = t.history.cpu().numpy()
    assert (hist == 1).mean() > 0.05 and (hist > 1).mean() > 0.3


@pytest.mark.card
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_kernel_equals_twin(card, h, w, step):
    f = asvgf_frame(h, w)
    illum, var, normal, depth, mesh, albedo = (
        torch.from_numpy(f[k]).to(card) for k in
        ("prev_illum", "variance", "normal", "depth", "mesh", "albedo"))
    _build.reset_counters()
    got_i, got_v = asvgf._atrous_step(illum, var, normal, depth, mesh, step)
    want_i, want_v = asvgf.atrous_iteration(illum, var, normal, depth, mesh,
                                            step=step)
    _bits_equal("illum", got_i, want_i)
    _bits_equal("variance", got_v, want_v)
    rgb, none = asvgf._atrous_step(illum, var, normal, depth, mesh, step,
                                   albedo=albedo)
    assert none is None and _build.launches["asvgf_atrous", None] == 2
    _bits_equal("rgb", rgb, asvgf.modulate(want_i, albedo))


@pytest.mark.card
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("iterations", [0, 2, 4])
def test_denoise_kernels_equal_twin(card, h, w, iterations):
    args = _args(asvgf_frame(h, w), card)
    _build.reset_counters()
    with spans.recording() as rec:
        got = asvgf.denoise(*args, iterations=iterations)
    assert rec.counts == {("asvgf", "cuda"): 1}
    assert _launched() == (1, iterations)
    _frame_equal(got, asvgf.denoise_plain(*args, iterations=iterations))
    # The twins on CPU tensors of the same frame, which
    # tests/test_torch_denoise.py holds to the reference at this tolerance:
    # the chain from the kernels to the reference.
    cpu_out, cpu_t, cpu_rgb = asvgf.denoise_plain(
        *_args(asvgf_frame(h, w), "cpu"), iterations=iterations)
    out, t, rgb = got
    for name, a, b in (("denoised", out, cpu_out), *zip(
            asvgf.TemporalOut._fields, t, cpu_t),
            ("temporal_rgb", rgb, cpu_rgb)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6,
                                   msg=name)


@pytest.mark.card
def test_viewer_hall_frames_equal_twin(card, monkeypatch):
    """Three consecutive 640x360 frames of the viewer hall (the textured
    hall with 200 props, A-SVGF at 4 iterations) as the renderer runs
    them, the history carried from frame to frame: each frame's kernels
    against the twins on that frame's inputs."""
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch.render import renderer as rmod

    calls = []

    def recorded(*args, iterations):
        _build.reset_counters()
        out = asvgf.denoise(*args, iterations=iterations)
        calls.append((args, iterations, out, *_launched()))
        return out

    monkeypatch.setattr(rmod, "denoise", recorded)
    r = lt.Renderer((1280, 720), lt.RenderConfig(), device=card)
    r.set_resources(lt.build_scene_buffers(lt.build_arch_scene(
        260_000, textured=True, props=200, merged=True)))
    r.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    view = lt.arch_camera()
    for _ in range(3):
        view[0, 3] += 0.05
        r.raytrace(view)
    assert len(calls) == 3
    for k, (args, iterations, got, n_t, n_a) in enumerate(calls):
        assert args[0].shape == (360, 640, 3) and iterations == 4
        assert (n_t, n_a) == (1, 4)
        _frame_equal(got, asvgf.denoise_plain(*args, iterations=iterations))
        hist = got[1].history
        if k:  # the history is carried: most pixels reproject
            assert float((hist > 1).float().mean()) > 0.5, k
    assert torch.equal(r.state.denoised, calls[-1][2][0])


@pytest.mark.card
def test_kernel_wrappers_check_inputs(card):
    args = list(_args(asvgf_frame(24, 40), card))
    _build.reset_counters()
    bad = [
        (1, args[1].transpose(0, 1).contiguous().transpose(0, 1)),  # strides
        (1, args[1].double()),
        (5, args[5].long()),
        (8, args[8].float()),
        (2, args[2][:, :20]),
    ]
    for i, x in bad:
        a = list(args)
        a[i] = x
        with pytest.raises(ValueError):
            asvgf.denoise(*a)
    with pytest.raises(ValueError):
        asvgf.denoise(*args, iterations=3)
    with pytest.raises(ValueError):
        asvgf._atrous_step(args[9], args[11].double(), args[3], args[4],
                           args[5], 1)
    assert _launched() == (0, 0)


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("iterations", [0, 2, 4])
def test_cpu_tensors_take_the_twins(iterations):
    args = _args(asvgf_frame(24, 40), "cpu")
    _build.reset_counters()
    with spans.recording() as rec:
        got = asvgf.denoise(*args, iterations=iterations)
        t, rgb = asvgf.temporal(*args)
    assert rec.counts == {("asvgf", "plain"): 2}
    assert _launched() == (0, 0)
    want = asvgf.denoise_plain(*args, iterations=iterations)
    _frame_equal(got, want)
    for name, a, b in zip(asvgf.TemporalOut._fields, t, want[1]):
        _bits_equal(name, a, b)
    _bits_equal("temporal_rgb", rgb, want[2])
    # The plain twin is the function the reference's was compared with.
    illum = asvgf.demodulate(args[0], args[1])
    for a, b in zip(want[1], asvgf.temporal_reproject(illum, *args[2:])):
        _bits_equal("temporal", a, b)
    if iterations == 0:
        _bits_equal("denoised", got[0], rgb)


@pytest.mark.parametrize("iterations", [1, 3, 5])
def test_odd_iteration_count_raises(iterations):
    args = _args(asvgf_frame(24, 40), "cpu")
    _build.reset_counters()
    with pytest.raises(ValueError, match="even iteration count"):
        asvgf.denoise(*args, iterations=iterations)
    assert _launched() == (0, 0)


def test_other_devices_raise():
    args = [x.to("meta") for x in _args(asvgf_frame(8, 8), "cpu")]
    with pytest.raises(ValueError, match="no A-SVGF for device"):
        asvgf.denoise(*args)
    with pytest.raises(ValueError, match="no A-SVGF for device"):
        asvgf.temporal(*args)


def test_frame_modes_take_the_dispatch(monkeypatch):
    """``finish_frame`` in its ``denoised`` and ``temporal`` modes goes
    through ``denoise`` / ``temporal`` once a frame, inside its ``asvgf``
    span, and keeps what they return as the frame's state."""
    from loupiote_tpu_torch.render import renderer as rmod
    from loupiote_tpu_torch.render.integrator import GBuffer

    f = asvgf_frame(16, 24)
    h, w = 16, 24
    state = rmod.init_state(w, h, "cpu")
    gb = GBuffer(normal=torch.from_numpy(f["normal"]).reshape(-1, 3),
                 depth=torch.from_numpy(f["depth"]).reshape(-1),
                 mesh_id=torch.from_numpy(f["mesh"]).reshape(-1),
                 albedo=torch.from_numpy(f["albedo"]).reshape(-1, 3),
                 world_pos=torch.zeros(h * w, 3))
    img = torch.from_numpy(f["radiance"])
    for mode in ("denoised", "temporal"):
        with spans.recording() as rec:
            new = rmod.finish_frame(state, img, gb, torch.eye(4), False,
                                    width=w, height=h, mode=mode,
                                    atrous_iterations=4)
        assert rec.counts[("asvgf", "plain")] == 1
        assert [s.name for s in rec.spans] == ["finish", "asvgf"]
        args = (img, gb.albedo.reshape(h, w, 3), new.motion,
                gb.normal.reshape(h, w, 3), gb.depth.reshape(h, w),
                gb.mesh_id.reshape(h, w), state.gb_normal, state.gb_depth,
                state.gb_mesh, state.asvgf_illum, state.asvgf_moments,
                state.asvgf_history)
        out, t, rgb = asvgf.denoise_plain(*args, iterations=4)
        for name, a, b in (("illum", new.asvgf_illum, t.illum),
                           ("moments", new.asvgf_moments, t.moments),
                           ("history", new.asvgf_history, t.history),
                           ("temporal_rgb", new.temporal_rgb, rgb)):
            _bits_equal(name, a, b)
        if mode == "denoised":
            _bits_equal("denoised", new.denoised, out)
        else:
            assert np.array_equal(new.denoised.numpy(),
                                  state.denoised.numpy())
