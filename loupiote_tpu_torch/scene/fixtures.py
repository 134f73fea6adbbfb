"""Small inputs made from a seed: a textured golden scene and its camera,
an HDR sky, rays with non-finite components, and a scene written as a
GLB file with PNG or JPEG textures. chip_smoke.py drives the card with them and
the CPU tests hold the port to the reference on them.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..image_codec import encode_jpeg, encode_png
from .types import INVALID_INDEX, ImageData, Instance, Light, Material, Mesh, Scene


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


def scene_glb(scene: Scene, image_format: str = "png") -> bytes:
    """``scene`` as GLB bytes: one glTF mesh of one primitive for each
    mesh (its instances must share one material), every material, one
    node a instance (its matrix), every image in the binary chunk as a
    PNG or, with ``image_format="jpeg"``, as a JPEG (``encode_jpeg``, its
    alpha dropped). Lights are not written (glTF's core has none).
    ``load_gltf`` of the bytes into ``Scene.default()`` gives the meshes,
    instances, materials and, with PNG, the texels back, the materials
    and instances after the default material."""
    encode, mime = {"png": (encode_png, "image/png"),
                    "jpeg": (encode_jpeg, "image/jpeg")}[image_format]
    mesh_mat = {}
    for inst in scene.instances:
        if mesh_mat.setdefault(inst.mesh_index,
                               inst.material_index) != inst.material_index:
            raise ValueError(f"mesh {inst.mesh_index} is instanced with two "
                             f"materials")
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

    def tex(index) -> dict:
        ok = 0 <= int(index) < len(scene.images)
        return {"index": int(index)} if ok else None

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
    images = [{"bufferView": view(encode(np.ascontiguousarray(
        img.data, np.uint8))), "mimeType": mime} for img in scene.images]
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


def write_glb(scene: Scene, path: str, image_format: str = "png") -> None:
    with open(path, "wb") as f:
        f.write(scene_glb(scene, image_format))
