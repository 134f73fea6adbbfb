"""A whole two-level frame of the port (trace_paths on instanced buffers)
against the reference's, with the reference's draws replayed.

The merged arch-4k hall with 20 props (K = 21 instances: the hall's BLAS
behind its box cull, then two candidate groups of 10 props), 3 bounces
with NEE at 32 x 32 pixels, aimed at a prop by the +x wall, traced
from the reference's primary rays, as tests/test_torch_frame.py's
textured case is (the two generate_rays normalise in another order).
Radiance is held as that file holds flattened frames: 99.5% of pixels
within rtol 1e-4 / atol 1e-5, the mean within 1e-4; the G-buffer's
instance ids equal on 99.5% of pixels, props among them. The hall is
untextured: textured, an ulp of a hit point moves a bilinear atlas
fetch by up to ~1e-3, past rtol 1e-4, and a 32 x 32 frame of this hall
from arch_camera() kept 99.3% of its pixels in the gate instanced and
98.4% flattened. Both sides run TLAS_C = 1 candidate wave a group (the
drain would take any ray that overlaps more boxes of a group; none does
in this frame): the reference's candidate path on the CPU compiles each
wave's traversal anew (a frame takes about 200 s at the default
C = 12, 60 s at C = 1). On the CPU the reference's instanced frame
equals its own flattened frame (every pixel of an untextured 32 x 32
frame of this hall from arch_camera() within the gate), so the fault R2
(ROADMAP) does not show.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.render.integrator import trace_paths as ref_trace_paths
from loupiote_tpu.scene.instanced import \
    build_instanced_buffers as ref_build_instanced
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import from_reference, trace_paths
from loupiote_tpu_torch.render import integrator
from loupiote_tpu_torch.scene import instanced
from torch_port_helpers import numpy_bvh, replay_uniforms


def _look(origin, forward):
    """Camera-to-world looking along ``forward``, as arch_camera builds
    its view."""
    f = np.asarray(forward, np.float32)
    f /= np.linalg.norm(f)
    r = np.cross(f, [0, 1, 0])
    r /= np.linalg.norm(r)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = r, np.cross(r, f), f
    m[:3, 3] = origin
    return m


@pytest.fixture(scope="module")
def hall20():
    with numpy_bvh():
        scene = ref_arch(4_000, props=20, merged=True)
        return ref_build_instanced(scene)


def test_frame_matches_reference_with_replayed_uniforms(hall20, monkeypatch):
    port = from_reference(hall20, device="cpu")
    assert len(port.inst_mesh) == 21

    def reference_rays(cam, width, height, vfov, jitter, row_offset=0,
                       rows=None):
        o, d = ref_generate_rays(jnp.asarray(cam.numpy()), width, height,
                                 vfov, jnp.asarray(jitter.numpy()),
                                 row_offset=row_offset, rows=rows)
        return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))

    monkeypatch.setattr(integrator, "generate_rays", reference_rays)
    monkeypatch.setenv("LOUPIOTE_TLAS_C", "1")
    monkeypatch.setattr(instanced, "TLAS_C", 1)
    W, H, B = 32, 32, 3
    key = jr.PRNGKey(5)
    cam = _look(origin=(11.0, 2.0, 0.0), forward=(3.4, -1.2, -2.3))
    ref_img, ref_gb = ref_trace_paths(hall20, jnp.asarray(cam), W, H, key,
                                      bounces=B, sort_rays=False)
    img, gb = trace_paths(port, torch.from_numpy(cam), W, H, bounces=B,
                          sort_rays=False,
                          uniforms=replay_uniforms(key, W * H, B))
    ref_img, img = np.asarray(ref_img), img.numpy()
    close = np.isclose(img, ref_img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(img.mean() / ref_img.mean() - 1) < 1e-4
    assert (img.sum(axis=1) > 0).mean() > 0.4
    ids, ref_ids = gb.mesh_id.numpy(), np.asarray(ref_gb.mesh_id)
    assert (ids == ref_ids).mean() >= 0.995 and (ids > 0).any()
