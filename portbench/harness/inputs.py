"""The benchmark's inputs, made from a cell's configuration and the run's
seed: the arch hall (a frozen, vectorised copy of the port's
``scene/procedural.py::build_arch_scene``), the scene as GLB bytes with
PNG textures (after ``scene/fixtures.py::scene_glb``), the sky (after
``scene/fixtures.py::sky_equirect``) as Radiance ``.hdr`` bytes, and the
camera of every frame.

A later edit to the port's generators does not move these inputs.
``portbench/tests/test_pb_inputs.py`` holds the hall to the port's
generator as it stood when this copy was made.
"""

from __future__ import annotations

import json
import math
import struct
import zlib

import numpy as np

from ..reference.probe import float_to_rgbe
from ..reference.scene_types import (INVALID_INDEX, ImageData, Instance,
                                     Light, Material, Mesh, Scene)


# -- the hall ----------------------------------------------------------------

# (u, v, w) axes of each face: the face's centre is at w / 2. The port's
# generator also writes the +x and +y faces a second time, coincident with
# these but with the u and v axes reversed; which of two coincident
# triangles a ray hits is then the BVH's tie-break, and their textures
# differ, so an image would depend on the tree. This copy writes each face
# once. Like the port's, it writes no -x and no -y face: the hall is open
# on its -x side and stands on its floor relief.
_BOX_AXES = (((1, 0, 0), (0, 1, 0), (0, 0, 1)),
             ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
             ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
             ((0, 0, 1), (1, 0, 0), (0, 1, 0)))


def _tessellated_box(center, size, segments):
    """Box surface subdivided into segments^2 quads per face, in the vertex
    order and arithmetic of the port's generator, each face once.
    Returns (verts (V,3) float32, idx (I,) uint32, uvs (V,2) float32)."""
    n = segments
    c = np.array(center, np.float64)
    s = np.array(size, np.float64)
    ij = np.arange(n + 1, dtype=np.float64)
    ii, jj = np.meshgrid(ij, ij, indexing="ij")
    u = (ii / n * 2.0 - 1.0).reshape(-1, 1)
    v = (jj / n * 2.0 - 1.0).reshape(-1, 1)
    uvs = np.stack([(ii / n).reshape(-1), (jj / n).reshape(-1)], axis=1)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    quad = np.stack([a, a + n + 1, a + 1, a + 1, a + n + 1, a + n + 2],
                    axis=1).reshape(-1)
    verts, idx = [], []
    for f, axes in enumerate(_BOX_AXES):
        ua, va, wa = (np.array(x, np.float64) * s for x in axes)
        verts.append(c + u * ua / 2 + v * va / 2 + wa / 2)
        idx.append(quad + f * (n + 1) * (n + 1))
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(idx).astype(np.uint32),
            np.tile(uvs, (len(_BOX_AXES), 1)).astype(np.float32))


def _procedural_images(n: int = 6, size: int = 128) -> list:
    """Six RGBA8 textures (checker, stripes, bricks, noise, rings,
    gradient), as the port's generator makes them."""
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    patterns = [
        ((xx // 16 + yy // 16) % 2).astype(np.float32),
        ((xx // 8) % 2).astype(np.float32),
        (((yy // 16) % 2) * 0.5
         + ((xx + 8 * (yy // 16)) // 16 % 2) * 0.5).astype(np.float32),
        rng.random((size, size)).astype(np.float32),
        (np.sin(np.hypot(xx - size / 2, yy - size / 2) / 4) * 0.5
         + 0.5).astype(np.float32),
        (xx / size).astype(np.float32),
    ]
    tints = [(1.0, 0.9, 0.8), (0.8, 0.9, 1.0), (0.9, 0.6, 0.5),
             (0.7, 0.8, 0.7), (1.0, 0.8, 0.6), (0.8, 0.8, 0.9)]
    imgs = []
    for k in range(n):
        p = patterns[k % len(patterns)]
        t = tints[k % len(tints)]
        rgb = np.stack([(0.25 + 0.7 * p) * ch for ch in t], axis=-1)
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        imgs.append(ImageData.from_array(
            (np.clip(rgba, 0, 1) * 255).astype(np.uint8)))
    return imgs


def build_hall(triangles: int = 260_000, layout_seed: int = 11,
               textured: bool = False, props: int = 0) -> Scene:
    """The arch hall: a shell, a grid of 20 pillars and a rough floor of
    about ``triangles`` triangles; ``textured`` adds six atlas images and
    UVs, ``props`` boxes of two shared meshes under random transforms."""
    rng = np.random.default_rng(layout_seed)
    scene = Scene(materials=[Material()], lights=[Light()])
    if textured:
        scene.images = _procedural_images(6)
    hall_w, hall_h, hall_d = 40.0, 12.0, 80.0
    tris = 0

    def add_mesh(verts, idx, color, rough, metal, uvs=None, tex=-1,
                 instance=True):
        nonlocal tris
        mi = len(scene.meshes)
        scene.meshes.append(Mesh(verts, None, uvs if textured else None, idx))
        mat = len(scene.materials)
        scene.materials.append(Material(
            color=np.array(list(color) + [1.0], np.float32),
            roughness=rough, reflectivity=metal,
            albedo_texture=tex if textured else -1))
        if instance:
            scene.instances.append(Instance(mi, np.eye(4, dtype=np.float32),
                                            mat))
            tris += len(idx) // 3
        return mi

    v, i, uv = _tessellated_box((0, hall_h / 2, 0), (hall_w, hall_h, hall_d),
                                8)
    add_mesh(v, i, (0.7, 0.65, 0.6), 0.8, 0.0, uvs=uv * 4.0, tex=0)
    n_pillars = 2 * 10
    seg = max(int(np.sqrt(max(triangles - tris, 1)
                          / (n_pillars * 2 * len(_BOX_AXES)))), 1)
    for row in range(10):
        for side in (-1, 1):
            x = side * hall_w * 0.3
            z = (row - 4.5) * (hall_d * 0.09)
            v, i, uv = _tessellated_box((x, hall_h * 0.4, z),
                                        (2.0, hall_h * 0.8, 2.0), seg)
            add_mesh(v, i, (0.75, 0.7, 0.62), 0.6, 0.0, uvs=uv,
                     tex=1 + (row + max(side, 0)) % 4)
    remaining = max(triangles - tris, 2)
    g = max(int(np.sqrt(remaining / 2)), 2)
    xs = np.linspace(-hall_w / 2 * 0.98, hall_w / 2 * 0.98, g + 1)
    zs = np.linspace(-hall_d / 2 * 0.98, hall_d / 2 * 0.98, g + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (rng.random(gx.shape) * 0.08).astype(np.float32) + 0.02
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([(gx - xs[0]) / (xs[-1] - xs[0]),
                    (gz - zs[0]) / (zs[-1] - zs[0])],
                   axis=-1).reshape(-1, 2).astype(np.float32) * 12.0
    p = (np.arange(g)[:, None] * (g + 1) + np.arange(g)[None, :]).reshape(-1)
    idx = np.stack([p, p + 1, p + g + 1, p + 1, p + g + 2, p + g + 1],
                   axis=1).reshape(-1)
    add_mesh(verts, idx.astype(np.uint32), (0.55, 0.52, 0.5), 0.9, 0.0,
             uvs=uvs, tex=5)
    if props > 0:
        prop_meshes = []
        for k, (sz, segp) in enumerate(((0.8, 2), (0.5, 3))):
            v, i, uv = _tessellated_box((0.0, 0.0, 0.0), (sz, sz, sz), segp)
            prop_meshes.append(add_mesh(v, i, (0.8, 0.7, 0.55), 0.5, 0.1,
                                        uvs=uv, tex=(2 + k) % 6,
                                        instance=False))
        prop_mat = len(scene.materials) - 1
        for k in range(props):
            s = 0.6 + 0.8 * rng.random()
            ang = rng.random() * 2 * np.pi
            c, sn = np.cos(ang), np.sin(ang)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                                 np.float32) * s
            side = -1 if k % 2 == 0 else 1
            m[:3, 3] = [side * (hall_w * 0.42 - 2.5 * rng.random()),
                        0.45 * s, (rng.random() - 0.5) * hall_d * 0.95]
            scene.instances.append(Instance(prop_meshes[k % 2], m, prop_mat))
    scene.lights = [Light(
        origin=np.array([-4.0, hall_h - 0.2, -30.0], np.float32),
        edge_u=np.array([8.0, 0.0, 0.0], np.float32),
        edge_v=np.array([0.0, 0.0, 60.0], np.float32),
        emission=np.array([1.0, 0.97, 0.9], np.float32), intensity=8.0)]
    return scene


# -- files -------------------------------------------------------------------

def encode_png(rgba: np.ndarray) -> bytes:
    """(H, W, 4) uint8 as an 8-bit RGBA PNG, every row unfiltered."""
    h, w = rgba.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgba, np.uint8)
                           .reshape(h, w * 4)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def scene_glb(scene: Scene) -> bytes:
    """``scene`` as GLB bytes: one glTF mesh of one primitive a mesh (its
    instances share one material), every material, one node an instance
    (its matrix), every image as a PNG in the binary chunk. Lights are
    not written: glTF's core has none."""
    mesh_mat = {}
    for inst in scene.instances:
        if mesh_mat.setdefault(inst.mesh_index,
                               inst.material_index) != inst.material_index:
            raise ValueError(f"mesh {inst.mesh_index} has two materials")
    blob = bytearray()
    views, accessors = [], []

    def view(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr: np.ndarray, kind: str) -> int:
        comp = 5125 if arr.dtype == np.uint32 else 5126
        accessors.append({"bufferView": view(arr.tobytes()),
                          "componentType": comp, "count": len(arr),
                          "type": kind})
        return len(accessors) - 1

    meshes = []
    for i, m in enumerate(scene.meshes):
        attrs = {"POSITION": accessor(
            np.ascontiguousarray(m.positions, np.float32), "VEC3")}
        if m.normals is not None:
            attrs["NORMAL"] = accessor(
                np.ascontiguousarray(m.normals, np.float32), "VEC3")
        if m.texcoords is not None:
            attrs["TEXCOORD_0"] = accessor(
                np.ascontiguousarray(m.texcoords, np.float32), "VEC2")
        prim = {"attributes": attrs, "mode": 4, "indices": accessor(
            np.ascontiguousarray(m.indices, np.uint32), "SCALAR")}
        if i in mesh_mat and mesh_mat[i] != int(INVALID_INDEX):
            prim["material"] = mesh_mat[i]
        meshes.append({"primitives": [prim]})

    def tex(index):
        return ({"index": int(index)}
                if 0 <= int(index) < len(scene.images) else None)

    materials = []
    for mat in scene.materials:
        pbr = {"baseColorFactor": [float(x) for x in mat.color],
               "roughnessFactor": float(mat.roughness),
               "metallicFactor": float(mat.reflectivity)}
        for key, t in (("baseColorTexture", tex(mat.albedo_texture)),
                       ("metallicRoughnessTexture", tex(mat.mra_texture))):
            if t is not None:
                pbr[key] = t
        materials.append({"pbrMetallicRoughness": pbr, "emissiveFactor": [
            float(x) for x in mat.emission]})
    images = [{"bufferView": view(encode_png(img.data)),
               "mimeType": "image/png"} for img in scene.images]
    nodes = [{"mesh": inst.mesh_index, "matrix": [
        float(x) for x in np.asarray(inst.model_to_world, np.float32).T
        .reshape(-1)]} for inst in scene.instances]
    blob.extend(b"\0" * (-len(blob) % 4))
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
           "meshes": meshes, "materials": materials,
           "textures": [{"source": i} for i in range(len(images))],
           "images": images, "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


def sky_equirect(h: int, w: int, seed: int) -> np.ndarray:
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


def hdr_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3) float32 as a Radiance ``.hdr`` file: new-style scanlines
    of literal runs only (no scanline can be read as a flat one)."""
    h, w = rgb.shape[:2]
    if not 8 <= w <= 0x7FFF:
        raise ValueError(f"width {w} outside the run-length format")
    rgbe = float_to_rgbe(rgb)
    out = [f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
           .encode()]
    starts = range(0, w, 128)
    for y in range(h):
        out.append(bytes((2, 2, w >> 8, w & 255)))
        for ch in range(4):
            line = rgbe[y, :, ch].tobytes()
            for x in starts:
                part = line[x:x + 128]
                out.append(bytes((len(part),)) + part)
    return b"".join(out)


# -- the camera ----------------------------------------------------------------

def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v)).astype(np.float32)


class CameraPath:
    """The camera (origin, direction) of every frame of a run, 1-based.

    ``fixed``: one origin and direction for every frame. ``loop``: the
    origin moves ``step`` units a frame along a closed polyline through
    ``waypoints`` points on an ellipse (``center``, ``radii`` in x and z)
    whose radii are jittered from the seed by up to ``jitter`` units,
    starting at a seeded point of it; the view turns ``yaw_step_deg`` a
    frame from a seeded yaw, at a fixed pitch. Every seed gets the same
    step, turn and loop size; only the points and the start move."""

    def __init__(self, spec: dict, seed: int):
        self.kind = spec["path"]
        if self.kind == "fixed":
            self.origin = np.asarray(spec["origin"], np.float32)
            self.direction = _unit(spec["direction"])
            return
        if self.kind != "loop":
            raise ValueError(f"unknown camera path {self.kind!r}")
        rng = np.random.default_rng([seed, 0x63616d])
        n = int(spec["waypoints"])
        ang = 2.0 * np.pi * np.arange(n) / n
        rad = 1.0 + rng.uniform(-1.0, 1.0, n) * float(spec["jitter"]) \
            / float(min(spec["radii"]))
        cx, cy, cz = spec["center"]
        pts = np.stack([cx + spec["radii"][0] * rad * np.cos(ang),
                        np.full(n, float(cy)),
                        cz + spec["radii"][1] * rad * np.sin(ang)], axis=1)
        self.points = np.concatenate([pts, pts[:1]])
        seg = np.linalg.norm(np.diff(self.points, axis=0), axis=1)
        self.cum = np.concatenate([[0.0], np.cumsum(seg)])
        self.start = float(rng.uniform(0.0, self.cum[-1]))
        self.yaw0 = float(rng.uniform(0.0, 2.0 * np.pi))
        self.step = float(spec["step"])
        self.yaw_step = math.radians(float(spec["yaw_step_deg"]))
        self.pitch = math.radians(float(spec["pitch_deg"]))

    def at(self, k: int):
        """(origin (3,), direction (3,)) float32 of frame ``k``."""
        if self.kind == "fixed":
            return self.origin.copy(), self.direction.copy()
        s = (self.start + (k - 1) * self.step) % self.cum[-1]
        i = int(np.searchsorted(self.cum, s, side="right")) - 1
        f = (s - self.cum[i]) / (self.cum[i + 1] - self.cum[i])
        origin = self.points[i] * (1.0 - f) + self.points[i + 1] * f
        yaw = self.yaw0 + (k - 1) * self.yaw_step
        d = [math.sin(yaw) * math.cos(self.pitch), math.sin(self.pitch),
             -math.cos(yaw) * math.cos(self.pitch)]
        return origin.astype(np.float32), _unit(d)
