"""Minimal glTF 2.0 / GLB loader producing ``Scene`` data (counterpart of
``loupiote_tpu/scene/gltf.py``).

As the reference: per mesh primitive, positions required, normals and
texcoords0 optional, indexed or not, triangles, strips and fans only;
PBR metallic-roughness materials with texture -> source image indices;
nodes flattened with their LOCAL transform only (the reference composes
no parent transform), one instance per primitive; images as RGBA8; no
lights.

Images decode with the port's own PNG and JPEG decoders
(``image_codec``), byte-equal to PIL's ``convert("RGBA")``; an image that
neither decodes (a progressive JPEG, say) raises ``GltfError`` naming it.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List, Optional

import numpy as np

from ..image_codec import CodecError, decode_jpeg, decode_png, is_jpeg, is_png
from .types import INVALID_INDEX, ImageData, Instance, Material, Mesh, Scene

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfError(ValueError):
    pass


def _parse_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise GltfError("not a GLB container")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset = 12
    doc = None
    binary = b""
    while offset + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset:offset + clen]
        offset = (offset + clen + 3) & ~3  # chunks are 4-byte aligned
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk)
        elif ctype == 0x004E4942:  # 'BIN'
            binary = bytes(chunk)
    if doc is None:
        raise GltfError("GLB missing JSON chunk")
    return doc, binary


def _load_buffers(doc, binary: bytes, base_dir: Optional[str]) -> List[bytes]:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(binary)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            if base_dir is None:
                raise GltfError(f"external buffer {uri!r} but no base dir")
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc, buffers, index: int) -> np.ndarray:
    acc = doc["accessors"][index]
    if "sparse" in acc:
        raise GltfError("sparse accessors unsupported")  # reference TODO too
    n = acc["count"]
    ncomp = _TYPE_SIZE[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" not in acc:
        return np.zeros((n, ncomp), dtype=dtype)

    bv = doc["bufferViews"][acc["bufferView"]]
    data = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", itemsize)
    if stride == itemsize:
        out = np.frombuffer(data, dtype=dtype, count=n * ncomp, offset=start)
        out = out.reshape(n, ncomp)
    else:
        raw = np.frombuffer(data, dtype=np.uint8)
        rows = np.empty((n, itemsize), np.uint8)
        for i in range(ncomp * np.dtype(dtype).itemsize):
            rows[:, i] = raw[start + i: start + i + stride * n: stride][:n]
        out = rows.view(dtype).reshape(n, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
    return out


def _node_local_matrix(node) -> np.ndarray:
    if "matrix" in node:
        # glTF matrices are column-major. Return row-major (M @ v convention).
        return np.array(node["matrix"], np.float32).reshape(4, 4).T
    t = np.array(node.get("translation", [0, 0, 0]), np.float32)
    q = np.array(node.get("rotation", [0, 0, 0, 1]), np.float32)  # x,y,z,w
    s = np.array(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def _strip_to_triangles(indices: np.ndarray) -> np.ndarray:
    n = len(indices) - 2
    tris = np.empty((max(n, 0), 3), indices.dtype)
    for i in range(n):
        if i % 2 == 0:
            tris[i] = (indices[i], indices[i + 1], indices[i + 2])
        else:
            tris[i] = (indices[i + 1], indices[i], indices[i + 2])
    return tris.reshape(-1)


def _fan_to_triangles(indices: np.ndarray) -> np.ndarray:
    n = len(indices) - 2
    tris = np.empty((max(n, 0), 3), indices.dtype)
    for i in range(n):
        tris[i] = (indices[0], indices[i + 1], indices[i + 2])
    return tris.reshape(-1)


def _decode_image(doc, buffers, base_dir, image_def, index) -> ImageData:
    if "bufferView" in image_def:
        bv = doc["bufferViews"][image_def["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0)
        raw = data[start:start + bv["byteLength"]]
    else:
        uri = image_def["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir or ".", uri), "rb") as f:
                raw = f.read()
    name = image_def.get("name") or image_def.get("uri", "")[:64]
    label = f"image {index}" + (f" ({name!r})" if name else "")
    if is_jpeg(raw):
        decode = decode_jpeg
    elif is_png(raw):
        decode = decode_png
    else:
        raise GltfError(f"{label} is neither PNG nor JPEG")
    try:
        return ImageData.from_array(decode(bytes(raw)))
    except CodecError as e:
        raise GltfError(f"{label} does not decode: {e}") from e


def load_gltf(data: bytes, scene: Scene, base_dir: Optional[str] = None) -> None:
    """Append the glTF/GLB content to ``scene`` (reference: gltf.rs:46-156)."""
    if data[:4] == b"glTF":
        doc, binary = _parse_glb(data)
    else:
        doc, binary = json.loads(data.decode("utf-8")), b""
    buffers = _load_buffers(doc, binary, base_dir)
    # Every image decodes before the scene changes: an image that does
    # not decode raises with the scene as it was.
    images = [_decode_image(doc, buffers, base_dir, image_def, i)
              for i, image_def in enumerate(doc.get("images", []))]

    mesh_offset = len(scene.meshes)
    mat_offset = len(scene.materials)
    texture_offset = len(scene.images)

    # glTF meshes can hold multiple primitives; the reference emits one BLAS
    # per primitive, then instances `bvh_offset + mesh.index()` per primitive
    # (gltf.rs:134-146). We keep a mesh.index -> [our mesh ids] map so each
    # node instance covers every primitive of its mesh.
    mesh_prims: List[List[int]] = []
    prim_material: List[List[int]] = []
    for mesh in doc.get("meshes", []):
        ours: List[int] = []
        mats: List[int] = []
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            if mode not in (4, 5, 6):  # TRIANGLES, STRIP, FAN (gltf.rs:68-72)
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            positions = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)[:, :3]
            normals = None
            if "NORMAL" in attrs:
                normals = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)[:, :3]
            texcoords = None
            if "TEXCOORD_0" in attrs:
                texcoords = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            if "indices" in prim:
                indices = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                indices = np.arange(len(positions), dtype=np.uint32)
            if mode == 5:
                indices = _strip_to_triangles(indices)
            elif mode == 6:
                indices = _fan_to_triangles(indices)
            indices = indices[: (len(indices) // 3) * 3]
            if len(indices) == 0:
                continue
            ours.append(len(scene.meshes))
            mats.append(prim.get("material", -1))
            scene.meshes.append(Mesh(positions, normals, texcoords, indices))
        mesh_prims.append(ours)
        prim_material.append(mats)

    def _tex_image_index(tex_index: int) -> int:
        textures = doc.get("textures", [])
        if 0 <= tex_index < len(textures) and "source" in textures[tex_index]:
            return texture_offset + textures[tex_index]["source"]
        return int(INVALID_INDEX)

    for material in doc.get("materials", []):
        pbr = material.get("pbrMetallicRoughness", {})
        base_tex = pbr.get("baseColorTexture")
        mr_tex = pbr.get("metallicRoughnessTexture")
        scene.materials.append(Material(
            color=np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            reflectivity=float(pbr.get("metallicFactor", 1.0)),
            albedo_texture=_tex_image_index(base_tex["index"]) if base_tex else int(INVALID_INDEX),
            mra_texture=_tex_image_index(mr_tex["index"]) if mr_tex else int(INVALID_INDEX),
            emission=np.array(material.get("emissiveFactor", [0, 0, 0]), np.float32),
        ))

    for node in doc.get("nodes", []):
        if "mesh" not in node:
            continue
        gltf_mesh = node["mesh"]
        model_to_world = _node_local_matrix(node)  # local only, like gltf.rs:135
        for our_mesh, mat in zip(mesh_prims[gltf_mesh], prim_material[gltf_mesh]):
            material_index = mat_offset + mat if mat >= 0 else int(INVALID_INDEX)
            scene.instances.append(Instance(
                mesh_index=our_mesh,
                model_to_world=model_to_world,
                material_index=material_index,
            ))

    scene.images.extend(images)


def load_gltf_path(path: str, scene: Scene) -> None:
    with open(path, "rb") as f:
        data = f.read()
    load_gltf(data, scene, base_dir=os.path.dirname(os.path.abspath(path)))
