"""Small inputs made from a seed: a textured golden scene and its camera,
an HDR sky, and rays with non-finite components. chip_smoke.py drives the
card with them and the CPU tests hold the port to the reference on them.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import ImageData, Instance, Light, Material, Mesh, Scene


def nonfinite_rays(ro: torch.Tensor, rd: torch.Tensor, seed: int):
    """Copies of (ro, rd) with edge cases (lane_gather_bench.inputs's
    nonfinite pattern): about one ray in eight of each origin component
    +inf, -inf or NaN, of each direction component +inf, -inf, -0, 1e-30
    or -1e-30."""
    edge = np.random.default_rng(seed)
    out = []
    for x, vals in ((ro, (np.inf, -np.inf, np.nan)),
                    (rd, (np.inf, -np.inf, -0.0, 1e-30, -1e-30))):
        a = x.cpu().numpy().copy()
        for c in range(3):
            pick = edge.random(len(a)) < 0.125
            a[pick, c] = edge.choice(np.array(vals, np.float32),
                                     int(pick.sum()))
        out.append(torch.from_numpy(a).to(x.device))
    return out


def sky_equirect(h: int, w: int, seed: int = 17) -> np.ndarray:
    """(h, w, 3) float32 sky radiance from a seed: a horizon-to-zenith
    gradient with 10% noise and a sun disc of radiance ~35 near
    (u, v) = (0.3, 0.25)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    rad = (0.2 + 0.8 * (1.0 - yy)[..., None] * np.array([0.6, 0.8, 1.2])) * (
        1.0 + 0.1 * rng.random((h, w, 1)))
    sun = (xx - 0.3) ** 2 * 4 + (yy - 0.25) ** 2 < 0.002
    rad[sun] = [40.0, 36.0, 30.0]
    return rad.astype(np.float32)


def textured_quad_scene() -> Scene:
    """The reference's textured golden scene (tests/test_golden_scenes.py):
    a floor quad with a 64x64 checker albedo texture and one quad light."""
    scene = Scene.default()
    check = np.zeros((64, 64, 4), np.uint8)
    check[..., 3] = 255
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    board = ((xx // 8 + yy // 8) % 2).astype(bool)
    check[board] = [230, 60, 40, 255]
    check[~board] = [40, 200, 230, 255]
    scene.images = [ImageData.from_array(check)]
    scene.materials = [Material(albedo_texture=0, roughness=1.0)]
    scene.meshes = [Mesh(
        np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
        np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        np.array([0, 1, 2, 0, 2, 3], np.int32))]
    scene.instances = [Instance(0, np.eye(4, dtype=np.float32), 0)]
    scene.lights = [Light(origin=np.array([-1.5, 3, -1.5], np.float32),
                          edge_u=np.array([3, 0, 0], np.float32),
                          edge_v=np.array([0, 0, 3], np.float32),
                          emission=np.ones(3, np.float32), intensity=6.0)]
    return scene


# The camera of that golden: at (0, 3, 3), pitched 45 degrees down.
TEX_CAM = np.array([[1, 0, 0, 0], [0, 0.7071, -0.7071, 3.0],
                    [0, -0.7071, -0.7071, 3.0], [0, 0, 0, 1]], np.float32)
