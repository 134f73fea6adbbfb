"""Raw binary mesh loader (counterpart of ``loupiote_tpu/scene/binary.py``).

Format: little-endian u32 triangle count, then 3 vec4 positions per
triangle. Flat facet normals ``cross(normalize(v0 - v1), normalize(v0 -
v2))``, not renormalised, as the reference computes them; appends one mesh,
an identity instance and a white material.
"""

from __future__ import annotations

import struct

import numpy as np

from .types import INVALID_INDEX, Instance, Material, Mesh, Scene


def load_binary(data: bytes, scene: Scene) -> None:
    (tri_count,) = struct.unpack_from("<I", data, 0)
    vertex_count = tri_count * 3
    pos4 = np.frombuffer(data, dtype="<f4", count=vertex_count * 4, offset=4)
    positions = pos4.reshape(vertex_count, 4)[:, :3].astype(np.float32)

    v0 = positions[0::3]
    v1 = positions[1::3]
    v2 = positions[2::3]

    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-20)

    normal = np.cross(_norm(v0 - v1), _norm(v0 - v2)).astype(np.float32)
    normals = np.repeat(normal, 3, axis=0)

    mesh_index = len(scene.meshes)
    material_index = len(scene.materials)
    scene.meshes.append(Mesh(
        positions=positions,
        normals=normals,
        texcoords=None,
        indices=np.arange(vertex_count, dtype=np.uint32),
    ))
    scene.instances.append(Instance(
        mesh_index=mesh_index,
        model_to_world=np.eye(4, dtype=np.float32),
        material_index=material_index,
    ))
    scene.materials.append(Material(
        color=np.array([1.0, 1.0, 1.0, 1.0], np.float32),
        roughness=1.0,
        reflectivity=0.0,
        albedo_texture=int(INVALID_INDEX),
        mra_texture=int(INVALID_INDEX),
    ))


def load_binary_from_path(path: str, scene: Scene) -> None:
    with open(path, "rb") as f:
        load_binary(f.read(), scene)
