"""The reference's scene tables: a frozen copy of the port's
``loupiote_tpu_torch/scene/buffers.py::build_scene_buffers`` (flatten the
instances, build the BVH, lay out the triangle, material and light
tables, collapse the tree to the wide table), the atlas and the probe,
worked out from the benchmark's own scene and sky. The tree comes from
``bvh.py``; only the BVH2's root box (the sort keys' and the scene exit's
frame) is used beside the wide table. A two-level scene's tables
(``instanced.py``) are a geometry-less shell's with the BLASes and the
instance table added.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .atlas import pack_atlas
from .bvh import LEAF_MAX, FlatBVH, build_bvh
from .probe import Probe
from .scene_types import INVALID_INDEX, Scene, pad_rows
from .wide_table import collapse_wide

_PAD = 128


def _ceil_to(n: int, m: int = _PAD) -> int:
    return max(((n + m - 1) // m) * m, m)


@dataclass
class Tables:
    """The tables the reference's frame reads, on one device."""

    trav_rows: torch.Tensor  # (rows, 128) wide table
    tri_pack: torch.Tensor  # (T, 9) [p0, e1, e2] in BVH leaf order
    tri_shade: torch.Tensor  # (T, 20) normals, uvs, mat, inst, geo normal
    mat_pack: torch.Tensor  # (M, 11)
    light_origin: torch.Tensor
    light_eu: torch.Tensor
    light_ev: torch.Tensor
    light_emission: torch.Tensor  # premultiplied by intensity
    atlas: torch.Tensor  # (layers, S, S, 4) uint8
    atlas_blocks: torch.Tensor  # (K, 5) int32
    probe: torch.Tensor
    probe_cdf_cond: torch.Tensor
    probe_cdf_marg: torch.Tensor
    probe_pdf: torch.Tensor
    node_min: torch.Tensor  # (1, 3): the root box
    node_max: torch.Tensor
    wide_end: int
    wide_stack: int
    num_nodes: int
    num_lights: int
    has_probe: bool
    has_textures: bool
    num_tris: int
    # Two-level scenes (``instanced.py``): one BLAS a mesh and the
    # instance table; where ``blas`` is set, the tables above are a
    # geometry-less shell's, ``node_min`` / ``node_max`` the instances'
    # world bounds and ``tri_pack`` / ``tri_shade`` the BLASes' triangles
    # end to end, in object space.
    blas: Optional[tuple] = None  # tuple[instanced.Blas], by mesh slot
    inst_w2o: Optional[torch.Tensor] = None  # (K, 4, 4) world-to-object
    inst_nmat: Optional[torch.Tensor] = None  # (K, 3, 3) normal matrix
    inst_mat_id: Optional[torch.Tensor] = None  # (K,) int32 material
    inst_tri_base: Optional[torch.Tensor] = None  # (K,) int32 first tri
    inst_mesh: Optional[tuple] = None  # (K,) mesh slot of each instance
    inst_aabb_lo: Optional[torch.Tensor] = None  # (K, 3) world box
    inst_aabb_hi: Optional[torch.Tensor] = None  # (K, 3)

    @property
    def device(self) -> torch.device:
        return self.trav_rows.device


@dataclass
class Geometry:
    """The triangle tables of a flattened scene, on the host."""

    bvh: FlatBVH
    tri9: np.ndarray  # (T, 9) [p0, e1, e2] in BVH leaf order
    tri_pack: np.ndarray  # (Tp, 9), padding rows far away
    tri_shade: np.ndarray  # (Tp, 20)
    trav_rows: np.ndarray  # the wide table, padded
    wide_end: int
    wide_stack: int
    num_tris: int


def build_geometry(scene: Scene) -> Geometry:
    """Flatten ``scene``'s instances, build the BVH2 and lay out the
    triangle tables and the wide table, as the port's
    ``build_scene_buffers`` does."""
    p0s, p1s, p2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats, insts = [], []
    for inst_id, inst in enumerate(scene.instances):
        mesh = scene.meshes[inst.mesh_index]
        m = inst.model_to_world
        pos = mesh.positions @ m[:3, :3].T + m[:3, 3]
        idx = mesh.indices.reshape(-1, 3).astype(np.int64)
        a, b, c = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        p0s.append(a)
        p1s.append(b)
        p2s.append(c)
        if mesh.normals is None:
            # Facet normals when the mesh has none.
            fn = np.cross(b - a, c - a)
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True),
                                 1e-20)
            nrm3 = (fn, fn, fn)
        else:
            nrm = mesh.normals @ np.linalg.inv(m[:3, :3])
            nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                                   1e-20)
            nrm3 = (nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]])
        for out, x in zip((n0s, n1s, n2s), nrm3):
            out.append(x)
        if mesh.texcoords is None:
            z = np.zeros((len(idx), 2), np.float32)
            uv3 = (z, z, z)
        else:
            uv = mesh.texcoords
            uv3 = (uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]])
        for out, x in zip((uv0s, uv1s, uv2s), uv3):
            out.append(x)
        mat_id = inst.material_index
        if mat_id == int(INVALID_INDEX) or mat_id >= len(scene.materials):
            mat_id = 0
        mats.append(np.full(len(idx), mat_id, np.int32))
        insts.append(np.full(len(idx), inst_id, np.int32))
    if not p0s:
        # No geometry: one degenerate triangle far away keeps every table
        # shape valid, as the reference builds it (the shell of an
        # instanced build, scene/instanced.py).
        far = np.full((1, 3), 1e30, np.float32)
        p0s, p1s, p2s = [far], [far], [far]
        up = np.array([[0, 1, 0]], np.float32)
        n0s, n1s, n2s = [up], [up], [up]
        z = np.zeros((1, 2), np.float32)
        uv0s, uv1s, uv2s = [z], [z], [z]
        mats, insts = [np.zeros(1, np.int32)], [np.zeros(1, np.int32)]

    p0 = np.concatenate(p0s).astype(np.float32)
    p1 = np.concatenate(p1s).astype(np.float32)
    p2 = np.concatenate(p2s).astype(np.float32)
    bvh = build_bvh(p0, p1, p2, leaf_max=LEAF_MAX)
    order = bvh.tri_order

    def cat(parts):
        return np.concatenate(parts).astype(np.float32)[order]

    p0, p1, p2 = p0[order], p1[order], p2[order]
    n0, n1, n2 = cat(n0s), cat(n1s), cat(n2s)
    uv0, uv1, uv2 = cat(uv0s), cat(uv1s), cat(uv2s)
    tri_mat = np.concatenate(mats)[order]
    tri_inst = np.concatenate(insts)[order]

    T = p0.shape[0]
    Tp = _ceil_to(T)

    def padt(a, fill=0.0):
        return pad_rows(a, Tp, fill)

    e1 = (p1 - p0).astype(np.float32)
    e2 = (p2 - p0).astype(np.float32)
    tri_pack = np.concatenate([padt(p0, 1e30), padt(e1), padt(e2)], axis=1)
    tri9 = np.concatenate([p0, e1, e2], axis=1)

    def i32col(v):
        return v.astype(np.int32).view(np.float32)[:, None]

    geo_n = np.cross(p1 - p0, p2 - p0)
    geo_n = geo_n / np.maximum(np.linalg.norm(geo_n, axis=1, keepdims=True),
                               1e-20)
    tri_shade = np.concatenate([
        padt(n0), padt(n1), padt(n2),
        pad_rows(uv0, Tp), pad_rows(uv1, Tp), pad_rows(uv2, Tp),
        i32col(pad_rows(tri_mat, Tp, 0)),
        i32col(pad_rows(tri_inst, Tp, -1)),
        padt(geo_n.astype(np.float32)),
    ], axis=1).astype(np.float32)
    wide = collapse_wide(bvh, tri9)
    # +2 rows, as the reference pads; padded rows read as internal nodes
    # with all-empty children.
    trav = pad_rows(wide.trav_rows, _ceil_to(wide.trav_rows.shape[0] + 2, 8),
                    0.0)
    for c in range(8):
        trav[wide.end_index:, 16 * c:16 * c + 3] = 1e30
        trav[wide.end_index:, 16 * c + 3:16 * c + 6] = -1e30
        trav[wide.end_index:, 16 * c + 6] = np.int32(-1).view(np.float32)
    wide_stack = 16
    while wide_stack < wide.stack_need:
        wide_stack *= 2

    return Geometry(bvh=bvh, tri9=tri9, tri_pack=tri_pack,
                    tri_shade=tri_shade, trav_rows=trav,
                    wide_end=int(wide.end_index), wide_stack=int(wide_stack),
                    num_tris=T)


def build_tables(scene: Scene, probe: Optional[Probe] = None,
                 atlas_size: int = 2048, device="cuda") -> Tables:
    """The reference's tables for ``scene`` (its lights as given) and
    ``probe``, on ``device``."""
    geo = build_geometry(scene)
    bvh = geo.bvh
    M = max(len(scene.materials), 1)
    Mp = _ceil_to(M, 8)
    mat_color = np.ones((Mp, 4), np.float32)
    mat_roughness = np.ones(Mp, np.float32)
    mat_metallic = np.zeros(Mp, np.float32)
    mat_albedo_tex = np.full(Mp, -1, np.int32)
    mat_mra_tex = np.full(Mp, -1, np.int32)
    mat_emission = np.zeros((Mp, 3), np.float32)
    for i, mt in enumerate(scene.materials):
        mat_color[i] = mt.color
        mat_roughness[i] = mt.roughness
        mat_metallic[i] = mt.reflectivity
        mat_albedo_tex[i] = (-1 if mt.albedo_texture == int(INVALID_INDEX)
                             else mt.albedo_texture)
        mat_mra_tex[i] = (-1 if mt.mra_texture == int(INVALID_INDEX)
                          else mt.mra_texture)
        mat_emission[i] = mt.emission

    Lp = _ceil_to(max(len(scene.lights), 1), 8)
    light_origin = np.zeros((Lp, 3), np.float32)
    light_eu = np.zeros((Lp, 3), np.float32)
    light_ev = np.zeros((Lp, 3), np.float32)
    light_emission = np.zeros((Lp, 3), np.float32)
    for i, lt in enumerate(scene.lights):
        light_origin[i] = lt.origin
        light_eu[i] = lt.edge_u
        light_ev[i] = lt.edge_v
        light_emission[i] = lt.emission * lt.intensity

    mat_pack = np.concatenate([
        mat_color, mat_roughness[:, None], mat_metallic[:, None],
        mat_emission,
        mat_albedo_tex.view(np.float32)[:, None],
        mat_mra_tex.view(np.float32)[:, None],
    ], axis=1).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    atlas = pack_atlas(scene.images, atlas_size)
    if probe is not None:
        tables = (probe.radiance, probe.cdf_cond, probe.cdf_marg, probe.pdf)
    else:
        tables = (np.zeros((1, 1, 3), np.float32), np.ones((1, 1), np.float32),
                  np.ones(1, np.float32),
                  np.full((1, 1), 1.0 / (4.0 * np.pi), np.float32))
    return Tables(
        trav_rows=dev(geo.trav_rows), tri_pack=dev(geo.tri_pack),
        tri_shade=dev(geo.tri_shade), mat_pack=dev(mat_pack),
        light_origin=dev(light_origin), light_eu=dev(light_eu),
        light_ev=dev(light_ev),
        light_emission=dev(light_emission), atlas=dev(atlas.texture),
        atlas_blocks=dev(atlas.blocks), probe=dev(tables[0]),
        probe_cdf_cond=dev(tables[1]), probe_cdf_marg=dev(tables[2]),
        probe_pdf=dev(tables[3]), node_min=dev(bvh.node_min[:1]),
        node_max=dev(bvh.node_max[:1]), wide_end=geo.wide_end,
        wide_stack=geo.wide_stack, num_nodes=bvh.num_nodes,
        num_lights=len(scene.lights), has_probe=probe is not None,
        has_textures=len(scene.images) > 0, num_tris=geo.num_tris)
