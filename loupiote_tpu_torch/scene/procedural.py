"""The arch hall benchmark scene (copy of
``loupiote_tpu/scene/procedural.py``).

``build_arch_scene`` synthesizes an architectural hall (pillars, a
tessellated shell and a rough floor) of a given triangle budget; at
260,000 triangles it is the headline frame's scene. ``textured=True``
attaches six procedural atlas images and per-mesh UVs; ``props`` adds
boxes of two shared meshes under random transforms, which
``build_scene_buffers`` flattens into the one BVH like every instance.
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


def _procedural_images(n: int = 6, size: int = 128) -> list:
    """Deterministic RGBA8 test textures (checker, stripes, bricks, noise,
    rings, gradient) — the atlas content for the textured bench scene."""
    from .types import ImageData

    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    imgs = []
    patterns = [
        ((xx // 16 + yy // 16) % 2).astype(np.float32),  # checker
        ((xx // 8) % 2).astype(np.float32),  # stripes
        (((yy // 16) % 2) * 0.5
         + ((xx + 8 * (yy // 16)) // 16 % 2) * 0.5).astype(np.float32),
        rng.random((size, size)).astype(np.float32),  # noise
        (np.sin(np.hypot(xx - size / 2, yy - size / 2) / 4) * 0.5
         + 0.5).astype(np.float32),  # rings
        (xx / size).astype(np.float32),  # gradient
    ]
    tints = [(1.0, 0.9, 0.8), (0.8, 0.9, 1.0), (0.9, 0.6, 0.5),
             (0.7, 0.8, 0.7), (1.0, 0.8, 0.6), (0.8, 0.8, 0.9)]
    for k in range(n):
        p = patterns[k % len(patterns)]
        t = tints[k % len(tints)]
        rgb = np.stack([(0.25 + 0.7 * p) * c for c in t], axis=-1)
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        imgs.append(ImageData.from_array(
            (np.clip(rgba, 0, 1) * 255).astype(np.uint8)))
    return imgs


def build_arch_scene(tri_budget: int = 260_000, seed: int = 11,
                     textured: bool = False, props: int = 0,
                     merged: bool = False) -> Scene:
    """Hall with pillars + rough floor, ~tri_budget triangles total.

    ``textured``: attach 6 procedural atlas images + per-mesh UVs so the
    atlas-sampling path (ops/texture.py) runs at bench scale.
    ``props``: add this many prop boxes (two shared meshes, randomized
    transforms); ``build_scene_buffers`` flattens them into the one BVH.
    ``merged``: emit the whole hall as ONE mesh + one instance, the shape
    a two-level build takes (static architecture + the prop instances);
    flattened, it only concatenates the hall's meshes.
    """
    rng = np.random.default_rng(seed)
    scene = Scene.default()
    scene.materials = [Material()]
    if textured:
        scene.images = _procedural_images(6)

    hall_w, hall_h, hall_d = 40.0, 12.0, 80.0

    meshes_tris = 0
    merged_parts = []  # (verts, idx, uvs) when merged=True

    def add_mesh(verts, idx, color, rough, metal, uvs=None, tex=-1,
                 instance=True):
        nonlocal meshes_tris
        if merged and instance:
            merged_parts.append((verts, idx, uvs))
            meshes_tris += len(idx) // 3
            return None, None
        mi = len(scene.meshes)
        scene.meshes.append(Mesh(verts, None,
                                 uvs if textured else None, idx))
        mat = len(scene.materials)
        scene.materials.append(Material(
            color=np.array(list(color) + [1.0], np.float32),
            roughness=rough, reflectivity=metal,
            albedo_texture=tex if textured else -1))
        if instance:
            scene.instances.append(Instance(mi, np.eye(4, dtype=np.float32),
                                            mat))
            meshes_tris += len(idx) // 3
        return mi, mat

    # Walls/ceiling/floor shell (inward-facing box).
    v, i, uv = _tessellated_box((0, hall_h / 2, 0),
                                (hall_w, hall_h, hall_d), 8)
    add_mesh(v, i, (0.7, 0.65, 0.6), 0.8, 0.0, uvs=uv * 4.0, tex=0)

    # Pillar grid: most of the triangle budget.
    n_pillars = 2 * 10
    seg = max(int(np.sqrt(max(tri_budget - meshes_tris, 1)
                          / (n_pillars * 12))), 1)
    for row in range(10):
        for side in (-1, 1):
            x = side * hall_w * 0.3
            z = (row - 4.5) * (hall_d * 0.09)
            v, i, uv = _tessellated_box((x, hall_h * 0.4, z),
                                        (2.0, hall_h * 0.8, 2.0), seg)
            add_mesh(v, i, (0.75, 0.7, 0.62), 0.6, 0.0, uvs=uv,
                     tex=1 + (row + max(side, 0)) % 4)

    # Rough floor relief grid to absorb the remaining budget.
    remaining = max(tri_budget - meshes_tris, 2)
    g = max(int(np.sqrt(remaining / 2)), 2)
    xs = np.linspace(-hall_w / 2 * 0.98, hall_w / 2 * 0.98, g + 1)
    zs = np.linspace(-hall_d / 2 * 0.98, hall_d / 2 * 0.98, g + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (rng.random(gx.shape) * 0.08).astype(np.float32) + 0.02
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([(gx - xs[0]) / (xs[-1] - xs[0]),
                    (gz - zs[0]) / (zs[-1] - zs[0])],
                   axis=-1).reshape(-1, 2).astype(np.float32) * 12.0
    idx = []
    for a in range(g):
        for b in range(g):
            p = a * (g + 1) + b
            idx += [p, p + 1, p + g + 1, p + 1, p + g + 2, p + g + 1]
    add_mesh(verts, np.asarray(idx, np.uint32), (0.55, 0.52, 0.5), 0.9, 0.0,
             uvs=uvs, tex=5)

    # Instanced props: a few shared meshes x many transforms (crates,
    # plinths) scattered along the hall walls.
    if props > 0:
        prop_meshes = []
        for k, (sz, segp) in enumerate(((0.8, 2), (0.5, 3))):
            v, i, uv = _tessellated_box((0.0, 0.0, 0.0), (sz, sz, sz), segp)
            mi, _ = add_mesh(v, i, (0.8, 0.7, 0.55), 0.5, 0.1, uvs=uv,
                             tex=(2 + k) % 6, instance=False)
            prop_meshes.append(mi)
        prop_mat = len(scene.materials) - 1
        for p in range(props):
            s = 0.6 + 0.8 * rng.random()
            ang = rng.random() * 2 * np.pi
            c, sn = np.cos(ang), np.sin(ang)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                                 np.float32) * s
            side = -1 if p % 2 == 0 else 1
            m[:3, 3] = [side * (hall_w * 0.42 - 2.5 * rng.random()),
                        0.45 * s,
                        (rng.random() - 0.5) * hall_d * 0.95]
            scene.instances.append(Instance(
                prop_meshes[p % len(prop_meshes)], m, prop_mat))

    if merged and merged_parts:
        # One hall mesh/BLAS: concatenate all static parts.
        vs, idxs, uvs = [], [], []
        off = 0
        for v, i, uv in merged_parts:
            vs.append(v)
            idxs.append(i.astype(np.int64) + off)
            uvs.append(uv if uv is not None else np.zeros((len(v), 2),
                                                          np.float32))
            off += len(v)
        mi = len(scene.meshes)
        scene.meshes.append(Mesh(
            np.concatenate(vs).astype(np.float32), None,
            np.concatenate(uvs).astype(np.float32) if textured else None,
            np.concatenate(idxs).astype(np.uint32)))
        mat = len(scene.materials)
        scene.materials.append(Material(
            color=np.array([0.7, 0.66, 0.6, 1.0], np.float32),
            roughness=0.8, albedo_texture=0 if textured else -1))
        scene.instances.insert(0, Instance(mi, np.eye(4, dtype=np.float32),
                                           mat))

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
