"""Device-side scene tables (counterpart of ``loupiote_tpu/scene/buffers.py``).

Holds only what the port's frame reads. Two ways in:
``build_scene_buffers`` is the port's own host path (flatten instances,
build the BVH2, lay out its row tables, collapse it to the wide table),
and ``from_reference`` carries a reference ``SceneBuffers`` across without
importing jax. Both put the tables on the card unless the caller names
another device. Ints stored bitcast in float32 tables (``tri_shade``
columns 15-16, ``mat_pack`` columns 9-10, ``node_rows`` columns 6-9, the
``trav_rows`` pointer lanes) are read back with ``.view(torch.int32)``,
never with a value cast.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..accel.bvh import LEAF_MAX, build_bvh, bvh_max_depth
from ..accel.wide import collapse_wide
from ..treelet.build import TreeletDevice, build_treelet_device
from .atlas import pack_atlas
from .hdr import Probe
from .types import INVALID_INDEX, Scene, pad_rows

_PAD = 128


def _ceil_to(n: int, m: int = _PAD) -> int:
    return max(((n + m - 1) // m) * m, m)


@dataclass
class SceneBuffers:
    """Flat float32 tables on one device."""

    # Wide traversal table (accel/wide.py layout), padded past wide_end
    # with empty internal rows.
    trav_rows: torch.Tensor  # (rows, 128)
    # BVH2 rows: [min(3), max(3), count, miss, right | leaf row,
    # axis | first triangle, 0 x 6], ints bitcast; padded past end_index
    # with empty boxes (min 1e30 > max -1e30).
    node_rows: torch.Tensor  # (Np, 16)
    # One row per BVH2 leaf: up to 14 triangles x [p0, e1, e2]; empty
    # slots have p0 = 1e30.
    leaf_rows: torch.Tensor  # (L, 128)
    # [p0.xyz, e1.xyz, e2.xyz] per triangle, in BVH leaf order.
    tri_pack: torch.Tensor  # (T, 9)
    # [n0, n1, n2, uv0, uv1, uv2, mat (bitcast), inst (bitcast), geo normal]
    tri_shade: torch.Tensor  # (T, 20)
    # [color(4), roughness, metallic, emission(3), albedo_tex, mra_tex]
    mat_pack: torch.Tensor  # (M, 11)
    light_origin: torch.Tensor  # (L, 3)
    light_eu: torch.Tensor  # (L, 3)
    light_ev: torch.Tensor  # (L, 3)
    light_emission: torch.Tensor  # (L, 3), premultiplied by intensity
    # Texture atlas (scene/atlas.py): layers of RGBA8 texels and each
    # texture's block (x, y, layer, w, h).
    atlas: torch.Tensor  # (layers, S, S, 4) uint8
    atlas_blocks: torch.Tensor  # (K, 5) int32
    # Environment probe (scene/hdr.py); one-texel placeholders without one.
    probe: torch.Tensor  # (Hp, Wp, 3) radiance
    probe_cdf_cond: torch.Tensor  # (Hc, Wc) per-row conditional CDF
    probe_cdf_marg: torch.Tensor  # (Hc,) marginal CDF over rows
    probe_pdf: torch.Tensor  # (Hc, Wc) solid-angle pdf
    # BVH2 node bounds; row 0 is the scene box (sort keys, scene exit).
    node_min: torch.Tensor  # (N, 3)
    node_max: torch.Tensor  # (N, 3)
    wide_end: int
    wide_stack: int
    leaf_cap: int
    num_nodes: int
    end_index: int  # = num_nodes: the BVH2 traversal ends at this node
    stack_depth: int  # BVH2 stack entries: power of two >= 64, >= depth + 2
    num_lights: int
    has_probe: bool = False
    has_textures: bool = False
    num_tris: int = 0  # triangles before the padding rows
    # Treelet tables (treelet/build.py); None unless built with
    # treelets=True, and then intersect_any takes the treelet traversal.
    treelet: Optional[TreeletDevice] = None
    # Two-level instancing (scene/instanced.py): one BLAS (a SceneBuffers
    # of one mesh in object space) per unique mesh, shared by its
    # instances. Where ``inst_w2o`` is set, intersect_any and occluded
    # take the instance loop, the tables above are a geometry-less shell's
    # (node_min[0] / node_max[0] the instances' world bounds) and
    # tri_shade / tri_pack hold the BLASes' object-space triangles end to
    # end.
    blas: Optional[tuple] = None  # tuple[SceneBuffers], by mesh slot
    inst_w2o: Optional[torch.Tensor] = None  # (K, 4, 4) world-to-object
    inst_nmat: Optional[torch.Tensor] = None  # (K, 3, 3) normal matrix
    inst_mat_id: Optional[torch.Tensor] = None  # (K,) int32 material
    inst_tri_base: Optional[torch.Tensor] = None  # (K,) int32 first tri
    inst_mesh: Optional[tuple] = None  # (K,) mesh slot of each instance
    inst_aabb_lo: Optional[torch.Tensor] = None  # (K, 3) world box
    inst_aabb_hi: Optional[torch.Tensor] = None  # (K, 3)
    # The instance loop's plan and its device tables (instanced.TlasTables).
    tlas: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.trav_rows.device

    def to(self, device) -> "SceneBuffers":
        """A copy with every table on ``device``, each BLAS's too, and the
        instance loop's tables built again over the moved BLASes."""
        out = dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in _TENSOR_FIELDS
            + _INSTANCE_FIELDS if getattr(self, name) is not None},
            treelet=None if self.treelet is None
            else self.treelet.to(device),
            blas=None if self.blas is None
            else tuple(b.to(device) for b in self.blas))
        return _with_tlas(out) if self.tlas is not None else out

    def stats(self) -> dict:
        """Table sizes: BVH2 nodes, wide rows and, with treelets, the
        subtree count S, the top entries K and the treelet table bytes;
        instanced, the instance count, the unique meshes and the BLASes'
        bytes."""
        out = {"bvh2_nodes": self.num_nodes, "wide_rows": self.wide_end,
               "trav_rows_bytes": self.trav_rows.numel() * 4}
        if self.treelet is not None:
            out.update(subtrees=self.treelet.num_subtrees,
                       top_entries=self.treelet.num_top,
                       top_tiles=self.treelet.top_tiles,
                       treelet_bytes=self.treelet.nbytes())
        if self.blas is not None:
            out.update(instances=len(self.inst_mesh),
                       unique_meshes=len(self.blas),
                       blas_bytes=sum(b.nbytes() for b in self.blas))
        return out

    def nbytes(self) -> int:
        """Bytes of every table, the treelet tables and BLASes included."""
        n = sum(getattr(self, f).numel() * getattr(self, f).element_size()
                for f in _TENSOR_FIELDS + _INSTANCE_FIELDS
                if getattr(self, f) is not None)
        if self.treelet is not None:
            n += self.treelet.nbytes()
        return n + sum(b.nbytes() for b in self.blas or ())


def build_scene_buffers(scene: Scene, probe: Optional[Probe] = None,
                        atlas_size: int = 2048, device="cuda",
                        use_native: bool = True,
                        treelets: bool = False) -> SceneBuffers:
    """Flatten the scene's instances, build its BVH and upload the tables.

    ``probe``: the environment probe (``scene/hdr.py::build_probe``), lit
    on a geometry miss and sampled by next-event estimation.
    ``atlas_size``: the side of the atlas layers the scene's images are
    packed into.
    ``use_native``: build the BVH2 with the C++ builder (the shipped
    default); False selects the numpy builder, whose tree differs.
    ``treelets``: also build the treelet tables (``treelet/build.py``), so
    that closest-hit waves take the treelet traversal.
    """
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
    bvh = build_bvh(p0, p1, p2, leaf_max=LEAF_MAX, use_native=use_native)
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
    N = bvh.num_nodes
    Np = _ceil_to(N)

    def padt(a, fill=0.0):
        return pad_rows(a, Tp, fill)

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
    mat_pack = np.concatenate([
        mat_color, mat_roughness[:, None], mat_metallic[:, None],
        mat_emission,
        mat_albedo_tex.view(np.float32)[:, None],
        mat_mra_tex.view(np.float32)[:, None],
    ], axis=1).astype(np.float32)

    # BVH2 row tables (the reference's layout, byte for byte).
    is_leaf = bvh.count > 0
    leaf_ids = np.nonzero(is_leaf)[0]
    leaf_rows = np.zeros((max(len(leaf_ids), 1), 128), np.float32)
    for li, nd in enumerate(leaf_ids):
        f, c = int(bvh.first[nd]), min(int(bvh.count[nd]), LEAF_MAX)
        leaf_rows[li, :9 * c] = tri9[f:f + c].reshape(-1)
        for k in range(c, LEAF_MAX):
            leaf_rows[li, 9 * k:9 * k + 3] = 1e30
    slot8 = np.where(is_leaf, np.cumsum(is_leaf) - 1, bvh.right)
    slot9 = np.where(is_leaf, bvh.first, bvh.axis)
    node_rows = np.concatenate([
        bvh.node_min, bvh.node_max, i32col(bvh.count), i32col(bvh.miss),
        i32col(slot8), i32col(slot9), np.zeros((N, 6), np.float32),
    ], axis=1).astype(np.float32)
    node_rows = pad_rows(node_rows, Np, 0.0)
    node_rows[N:, 0:3] = 1e30
    node_rows[N:, 3:6] = -1e30
    stack_depth = 64
    while stack_depth < bvh_max_depth(bvh.count, bvh.miss) + 2:
        stack_depth *= 2

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

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    treelet = build_treelet_device(bvh, tri9, device) if treelets else None
    atlas = pack_atlas(scene.images, atlas_size)
    if probe is not None:
        tables = (probe.radiance, probe.cdf_cond, probe.cdf_marg, probe.pdf)
    else:
        tables = (np.zeros((1, 1, 3), np.float32), np.ones((1, 1), np.float32),
                  np.ones(1, np.float32),
                  np.full((1, 1), 1.0 / (4.0 * np.pi), np.float32))

    return SceneBuffers(
        trav_rows=dev(trav),
        node_rows=dev(node_rows),
        leaf_rows=dev(leaf_rows),
        tri_pack=dev(tri_pack),
        tri_shade=dev(tri_shade),
        mat_pack=dev(mat_pack),
        light_origin=dev(light_origin),
        light_eu=dev(light_eu),
        light_ev=dev(light_ev),
        light_emission=dev(light_emission),
        atlas=dev(atlas.texture),
        atlas_blocks=dev(atlas.blocks),
        probe=dev(tables[0]),
        probe_cdf_cond=dev(tables[1]),
        probe_cdf_marg=dev(tables[2]),
        probe_pdf=dev(tables[3]),
        node_min=dev(pad_rows(bvh.node_min, Np, 1e30)),
        node_max=dev(pad_rows(bvh.node_max, Np, -1e30)),
        wide_end=int(wide.end_index),
        wide_stack=int(wide_stack),
        leaf_cap=int(max(bvh.count.max(), wide.leaf_row_max)),
        num_nodes=N,
        end_index=N,
        stack_depth=stack_depth,
        num_lights=len(scene.lights),
        has_probe=probe is not None,
        has_textures=len(scene.images) > 0,
        num_tris=T,
        treelet=treelet,
    )


_TENSOR_FIELDS = ("trav_rows", "node_rows", "leaf_rows", "tri_pack",
                  "tri_shade", "mat_pack", "light_origin", "light_eu",
                  "light_ev", "light_emission", "atlas", "atlas_blocks",
                  "probe", "probe_cdf_cond", "probe_cdf_marg", "probe_pdf",
                  "node_min", "node_max")
_INSTANCE_FIELDS = ("inst_w2o", "inst_nmat", "inst_mat_id", "inst_tri_base",
                    "inst_aabb_lo", "inst_aabb_hi")


def from_reference(ref, device="cuda") -> SceneBuffers:
    """The port's buffers from a reference (JAX) ``SceneBuffers``.

    Each field's bytes are copied with ``np.asarray``, so this needs no
    jax import and bitcast ints (a -1 ``miss`` is a NaN pattern) survive;
    a reference ``TreeletDevice`` is copied the same way, and an instanced
    build's instance tables and BLASes (each through this function). The
    width-16 / multi-row-leaf tables are not ported and raise.
    """
    if int(ref.wide_width) != 8 or int(ref.wide_leaf_rows) != 1:
        raise NotImplementedError(
            "the port traverses only the 8-wide, one-row-leaf table")
    def copy(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(device)

    tensors = {name: copy(getattr(ref, name)) for name in _TENSOR_FIELDS}
    if getattr(ref, "inst_w2o", None) is not None:
        tensors.update({name: copy(getattr(ref, name))
                        for name in _INSTANCE_FIELDS})
        tensors.update(blas=tuple(from_reference(b, device)
                                  for b in ref.blas),
                       inst_mesh=tuple(int(m) for m in ref.inst_mesh))
    treelet = None
    td = getattr(ref, "treelet", None)
    if td is not None:
        treelet = TreeletDevice(
            top_fields=copy(td.top_fields), sub_fields=copy(td.sub_fields),
            sub_tri_base=copy(td.sub_tri_base), num_top=int(td.num_top),
            top_tiles=int(td.top_tiles), num_subtrees=int(td.num_subtrees))
    out = SceneBuffers(
        **tensors,
        wide_end=int(ref.wide_end),
        wide_stack=int(ref.wide_stack),
        leaf_cap=int(ref.leaf_cap),
        num_nodes=int(ref.num_nodes),
        end_index=int(ref.end_index),
        stack_depth=int(ref.stack_depth),
        num_lights=int(ref.num_lights),
        has_probe=bool(ref.has_probe),
        has_textures=bool(ref.has_textures),
        num_tris=int(ref.num_tris),
        treelet=treelet,
    )
    return _with_tlas(out) if out.blas is not None else out


def _with_tlas(bufs: SceneBuffers) -> SceneBuffers:
    """``bufs`` with the instance loop's tables built over its BLASes."""
    from .instanced import tlas_tables

    return dataclasses.replace(bufs, tlas=tlas_tables(
        bufs.blas, bufs.inst_mesh, bufs.inst_aabb_lo.cpu().numpy(),
        bufs.inst_aabb_hi.cpu().numpy()))
