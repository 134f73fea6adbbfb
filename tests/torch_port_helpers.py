"""Shared inputs for the parity tests of the PyTorch port
(tests/test_torch_*.py): scenes and rays made with numpy from a seed, the
reference's random streams replayed for the port, and float comparisons.
"""

import contextlib
import os

import numpy as np
import torch

from loupiote_tpu_torch.scene.fixtures import (TEX_CAM,  # noqa: F401
                                               nonfinite_rays, sky_equirect,
                                               textured_quad_scene)

# One intra-op thread: the suite runs several test processes side by side.
torch.set_num_threads(1)


@contextlib.contextmanager
def numpy_bvh():
    """Build reference scenes with the reference's numpy BVH builder."""
    old = os.environ.get("LOUPIOTE_NO_NATIVE")
    os.environ["LOUPIOTE_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LOUPIOTE_NO_NATIVE"]
        else:
            os.environ["LOUPIOTE_NO_NATIVE"] = old


def random_tris(seed=4321, n=500, spread=10.0, size=1.0):
    """The random triangle soup of tests/test_wide.py."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n, 3)) - 0.5) * spread
    v0 = base
    v1 = base + (rng.random((n, 3)) - 0.5) * size
    v2 = base + (rng.random((n, 3)) - 0.5) * size
    return v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32)


def soup_scene(types_module, v0, v1, v2):
    """A one-mesh Scene of the given triangles, from either package's
    ``scene.types`` module."""
    n = len(v0)
    scene = types_module.Scene.default()
    pos = np.empty((n * 3, 3), np.float32)
    pos[0::3], pos[1::3], pos[2::3] = v0, v1, v2
    scene.meshes.append(types_module.Mesh(pos, None, None,
                                          np.arange(n * 3, dtype=np.uint32)))
    scene.instances.append(types_module.Instance(
        0, np.eye(4, dtype=np.float32), 0))
    return scene


def random_rays(tris, R, seed=77):
    """Rays aimed at the soup (70%) or random, as tests/test_wide.py."""
    rng = np.random.default_rng(seed)
    v0, v1, _ = tris
    n = len(v0)
    ro = ((rng.random((R, 3)) - 0.5) * 25).astype(np.float32)
    tgt = (v0[rng.integers(0, n, R)] + v1[rng.integers(0, n, R)]) / 2
    rd = np.where(rng.random((R, 1)) < 0.7, tgt - ro,
                  rng.random((R, 3)) - 0.5).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def t_of(tri_pack, ro, rd, tri):
    """(u, v, t) of triangle ``tri`` along each ray: the reference's
    Moller-Trumbore formulas in numpy float32, every product rounded on
    its own (no fused multiply-add). t is +inf where tri < 0."""
    f = np.float32
    tp = np.asarray(tri_pack)[np.maximum(tri, 0)]
    p0, e1, e2 = tp[:, 0:3], tp[:, 3:6], tp[:, 6:9]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    pvx = dy * e2[:, 2] - dz * e2[:, 1]
    pvy = dz * e2[:, 0] - dx * e2[:, 2]
    pvz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(det) > f(1e-12), f(1) / det, f(0)).astype(f)
    tvx, tvy, tvz = (ro[:, 0] - p0[:, 0], ro[:, 1] - p0[:, 1],
                     ro[:, 2] - p0[:, 2])
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1[:, 2] - tvz * e1[:, 1]
    qvy = tvz * e1[:, 0] - tvx * e1[:, 2]
    qvz = tvx * e1[:, 1] - tvy * e1[:, 0]
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2[:, 0] * qvx + e2[:, 1] * qvy + e2[:, 2] * qvz) * inv
    return u, v, np.where(tri >= 0, t, np.inf).astype(f)


def ulp_diff(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_same_hits(tri_pack, ro, rd, ref_tri, port_tri):
    """``tri`` equal on every ray whose best t is not tied: a mismatch is
    allowed only where the two triangles lie within 2 ulp along the ray."""
    ref_tri, port_tri = np.asarray(ref_tri), np.asarray(port_tri)
    diff = ref_tri != port_tri
    if diff.any():
        t_ref = t_of(tri_pack, ro[diff], rd[diff], ref_tri[diff])[2]
        t_port = t_of(tri_pack, ro[diff], rd[diff], port_tri[diff])[2]
        tied = np.isfinite(t_ref) & (ulp_diff(t_ref, t_port) <= 2)
        assert tied.all(), (f"{(~tied).sum()} untied tri mismatches "
                            f"of {len(ref_tri)}")
    return ~diff


def replay_uniforms(key, n, bounces):
    """The reference trace_paths' jax.random draws, as port FrameUniforms:
    jitter from the frame key's first split, then per bounce the
    shade_step key's 8-way split (integrator.py:166,187,275;
    shade.py:386-398,419-421,441-446). ``n``: the wave's slots, spp x
    pixels."""
    import jax.random as jr

    from loupiote_tpu_torch.ops.sampling import FrameUniforms

    k_jit, k_bounce = jr.split(key)
    out = []
    for _ in range(bounces):
        k_bounce, k_step = jr.split(k_bounce)
        out.append(step_uniforms(k_step, n))
    return FrameUniforms(torch.from_numpy(np.array(jr.uniform(k_jit, (n, 2)))),
                         out)


def shard_uniforms(key, mesh_shape, n, bounces):
    """The reference's tile-parallel streams (loupiote_tpu/parallel/
    tiles.py:83-84): shard (ti, si) draws from fold_in(fold_in(key, ti),
    si), ``n`` slots (its slab's pixels), as a [ti][si] nest of port
    FrameUniforms."""
    import jax.random as jr

    n_tiles, n_spp = mesh_shape
    return [[replay_uniforms(jr.fold_in(jr.fold_in(key, ti), si), n, bounces)
             for si in range(n_spp)] for ti in range(n_tiles)]


def step_uniforms(k_step, n):
    """One shade_step's draws from its key, as port BounceUniforms; the
    environment pair from k_env's own split (drawn by the reference only
    where a probe is bound)."""
    import jax.random as jr

    from loupiote_tpu_torch.ops.sampling import BounceUniforms

    (_, k_env, k_lobe, k_u1, k_u2, k_ls, k_l1, k_l2) = jr.split(k_step, 8)
    ke1, ke2 = jr.split(k_env)

    def u(k):
        return torch.from_numpy(np.array(jr.uniform(k, (n,))))

    return BounceUniforms(u_sel=u(k_ls), u1_l=u(k_l1), u2_l=u(k_l2),
                          u_lobe=u(k_lobe), u1=u(k_u1), u2=u(k_u2),
                          u1_e=u(ke1), u2_e=u(ke2))


def psnr(a, b):
    peak = max(b.max(), 1e-6)
    mse = np.mean((a - b) ** 2)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-12))


def asvgf_frame(h, w, seed=2024):
    """A-SVGF inputs of an (h, w) frame, made with numpy from ``seed``:
    mesh ids in blocks (edges for the mesh test; -1 a miss), normals and
    depths piecewise smooth with jumps at the block edges, motion vectors
    of up to 3 pixels (bilinear taps past every border), a previous
    frame's state and a variance."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    yy, xx = np.mgrid[0:h, 0:w]
    mesh = ((yy // 7) * 3 + (xx // 11)).astype(np.int32) % 5 - 1  # -1 = miss
    base_n = rng.normal(size=(5, 3))
    n = base_n[mesh + 1] + 0.05 * rng.normal(size=(h, w, 3))
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(f32)
    depth = (2.0 + mesh + 0.1 * rng.random((h, w))).astype(f32)
    prev_mesh = mesh.copy()
    prev_mesh[rng.random((h, w)) < 0.1] = 3
    pn = normal + 0.02 * rng.normal(size=(h, w, 3))
    prev_normal = (pn / np.linalg.norm(pn, axis=-1, keepdims=True)).astype(f32)
    return dict(
        radiance=(rng.random((h, w, 3)) ** 3 * 4).astype(f32),
        albedo=rng.random((h, w, 3)).astype(f32),
        motion=((rng.random((h, w, 2)) - 0.5) * 6
                / np.array([w, h])).astype(f32),
        normal=normal, depth=depth, mesh=mesh,
        prev_normal=prev_normal,
        prev_depth=(depth * (1 + 0.05 * rng.normal(size=(h, w)))).astype(f32),
        prev_mesh=prev_mesh,
        prev_illum=(rng.random((h, w, 3)) * 2).astype(f32),
        prev_moments=rng.random((h, w, 2)).astype(f32),
        prev_history=rng.integers(0, 33, (h, w)).astype(f32),
        variance=(rng.random((h, w)) * 0.5).astype(f32),
    )
