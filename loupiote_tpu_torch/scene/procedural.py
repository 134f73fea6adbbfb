"""The arch hall benchmark scene (copy of
``loupiote_tpu/scene/procedural.py``).

``build_arch_scene`` synthesizes an architectural hall (pillars, a
tessellated shell and a rough floor) of a given triangle budget; at
260,000 triangles it is the headline frame's scene. Only the untextured,
uninstanced form is copied: that is the form the port renders.
"""

from __future__ import annotations

import numpy as np

from .types import Instance, Light, Material, Mesh, Scene


def _tessellated_box(center, size, segments) -> tuple:
    """Box surface subdivided into segments^2 quads per face.

    Returns (verts (V,3), idx (I,), uvs (V,2)).
    """
    cx, cy, cz = center
    sx, sy, sz = size
    verts = []
    uvs = []
    idx = []
    axes = [
        (np.array([sx, 0, 0]), np.array([0, sy, 0]), np.array([0, 0, sz])),
        (np.array([-sx, 0, 0]), np.array([0, sy, 0]), np.array([0, 0, -sz])),
        (np.array([0, sy, 0]), np.array([0, 0, sz]), np.array([sx, 0, 0])),
        (np.array([0, -sy, 0]), np.array([0, 0, -sz]), np.array([sx, 0, 0])),
        (np.array([0, 0, sz]), np.array([sx, 0, 0]), np.array([0, sy, 0])),
        (np.array([0, 0, -sz]), np.array([-sx, 0, 0]), np.array([0, sy, 0])),
    ]
    base = 0
    n = segments
    for u_axis, v_axis, w_axis in axes:
        for i in range(n + 1):
            for j in range(n + 1):
                u = i / n * 2.0 - 1.0
                v = j / n * 2.0 - 1.0
                p = (np.array([cx, cy, cz]) + u * u_axis / 2 + v * v_axis / 2
                     + w_axis / 2)
                verts.append(p)
                uvs.append((i / n, j / n))
        for i in range(n):
            for j in range(n):
                a = base + i * (n + 1) + j
                b = a + 1
                c = a + (n + 1)
                d = c + 1
                idx += [a, c, b, b, c, d]
        base += (n + 1) * (n + 1)
    return (np.asarray(verts, np.float32), np.asarray(idx, np.uint32),
            np.asarray(uvs, np.float32))


def build_arch_scene(tri_budget: int = 260_000, seed: int = 11) -> Scene:
    """Hall with pillars + rough floor, ~tri_budget triangles total."""
    rng = np.random.default_rng(seed)
    scene = Scene.default()
    scene.materials = [Material()]

    hall_w, hall_h, hall_d = 40.0, 12.0, 80.0
    meshes_tris = 0

    def add_mesh(verts, idx, color, rough, metal):
        nonlocal meshes_tris
        mi = len(scene.meshes)
        scene.meshes.append(Mesh(verts, None, None, idx))
        mat = len(scene.materials)
        scene.materials.append(Material(
            color=np.array(list(color) + [1.0], np.float32),
            roughness=rough, reflectivity=metal, albedo_texture=-1))
        scene.instances.append(Instance(mi, np.eye(4, dtype=np.float32), mat))
        meshes_tris += len(idx) // 3

    # Walls/ceiling/floor shell (inward-facing box).
    v, i, _ = _tessellated_box((0, hall_h / 2, 0),
                               (hall_w, hall_h, hall_d), 8)
    add_mesh(v, i, (0.7, 0.65, 0.6), 0.8, 0.0)

    # Pillar grid: most of the triangle budget.
    n_pillars = 2 * 10
    seg = max(int(np.sqrt(max(tri_budget - meshes_tris, 1)
                          / (n_pillars * 12))), 1)
    for row in range(10):
        for side in (-1, 1):
            x = side * hall_w * 0.3
            z = (row - 4.5) * (hall_d * 0.09)
            v, i, _ = _tessellated_box((x, hall_h * 0.4, z),
                                       (2.0, hall_h * 0.8, 2.0), seg)
            add_mesh(v, i, (0.75, 0.7, 0.62), 0.6, 0.0)

    # Rough floor relief grid to absorb the remaining budget.
    remaining = max(tri_budget - meshes_tris, 2)
    g = max(int(np.sqrt(remaining / 2)), 2)
    xs = np.linspace(-hall_w / 2 * 0.98, hall_w / 2 * 0.98, g + 1)
    zs = np.linspace(-hall_d / 2 * 0.98, hall_d / 2 * 0.98, g + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (rng.random(gx.shape) * 0.08).astype(np.float32) + 0.02
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = []
    for a in range(g):
        for b in range(g):
            p = a * (g + 1) + b
            idx += [p, p + 1, p + g + 1, p + 1, p + g + 2, p + g + 1]
    add_mesh(verts, np.asarray(idx, np.uint32), (0.55, 0.52, 0.5), 0.9, 0.0)

    # Skylight strip.
    scene.lights = [Light(
        origin=np.array([-4.0, hall_h - 0.2, -30.0], np.float32),
        edge_u=np.array([8.0, 0.0, 0.0], np.float32),
        edge_v=np.array([0.0, 0.0, 60.0], np.float32),
        emission=np.array([1.0, 0.97, 0.9], np.float32),
        intensity=8.0)]
    return scene


def arch_camera() -> np.ndarray:
    """Fly-through style viewpoint down the hall (camera-to-world)."""
    fwd = np.array([0.15, -0.12, -1.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = right, up, fwd
    m[:3, 3] = [0.0, 5.0, 34.0]
    return m
