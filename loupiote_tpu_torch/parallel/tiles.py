"""Tile-parallel frames: the image's rows split over a grid of devices
(counterpart of ``loupiote_tpu/parallel/tiles.py``).

The frame's rows are cut into ``n_tiles`` slabs of equal height; each
shard of the mesh traces its slab with its own random stream, on its own
device, from its own copy of the scene. An optional second axis, "spp",
gives a slab to several devices, each tracing one sample of it; their
radiance is averaged. The slabs are then gathered on the mesh's first
device, where accumulation or A-SVGF runs as in the one-device frame.

One process drives every device, as one controller drives the
reference's ``shard_map``: there is no ``torch.distributed`` group. Every
shard's work is issued before any result is read back, so on a host with
several cards the shards overlap as far as each shard's host work
allows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.intersect import full_device
from ..render.integrator import GBuffer, trace_paths

GBUFFER_PLANES = ("normal", "depth", "mesh_id", "albedo", "world_pos")


class Mesh:
    """A (n_tiles, n_spp) grid of devices: ``devices[ti, si]`` traces
    row slab ``ti``'s sample ``si``. ``shape`` is ``{"tiles": n_tiles,
    "spp": n_spp}``, as a ``jax.sharding.Mesh`` names its axes."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"tiles": self.devices.shape[0], "spp": self.devices.shape[1]}

    def distinct(self) -> list:
        """The mesh's devices, each once, in row-major order."""
        return list(dict.fromkeys(self.devices.ravel().tolist()))

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        return (f"Mesh(tiles={self.shape['tiles']}, spp={self.shape['spp']}"
                f", devices={names})")


def make_mesh(n_tiles: Optional[int] = None, n_spp: int = 1,
              devices=None) -> Mesh:
    """The first ``n_tiles * n_spp`` of ``devices`` as a (tiles, spp) mesh;
    ``n_tiles`` None: as many tiles as the devices fill.

    ``devices`` None: every CUDA device of the host; with none, this
    raises. A device may be listed more than once, and its shards then
    run one after another on it: that is how the tests build 4- and
    8-device meshes of ``torch.device("cpu")`` and how one card holds a
    3x1 or 2x2 mesh. It is a testing and bring-up aid: such a mesh
    traces the same frame as a mesh of distinct cards, no faster than one
    device.
    """
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [full_device(d) for d in devices]
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
    if n_tiles < 1 or n_spp < 1 or n_tiles * n_spp > len(devices):
        raise ValueError(f"a {n_tiles}x{n_spp} mesh needs "
                         f"{max(n_tiles, 1) * max(n_spp, 1)} devices, "
                         f"got {len(devices)}")
    grid = np.empty((n_tiles, n_spp), dtype=object)
    for i, d in enumerate(devices[:n_tiles * n_spp]):
        grid[i // n_spp, i % n_spp] = d
    return Mesh(grid)


def replicate_scene(scene, mesh: Mesh) -> dict:
    """{device: the scene's buffers on it}, one copy for each distinct
    device of the mesh (a copy already on that device is the scene
    itself)."""
    return {d: scene.to(d) for d in mesh.distinct()}


def shard_generator(key, ti: int, si: int, device) -> torch.Generator:
    """Shard (ti, si)'s generator on ``device``, seeded on the host from
    the frame's ``key`` (a tuple of non-negative ints) and the shard's
    place, as the reference folds its frame key with ti, then si."""
    seed = np.random.SeedSequence([*key, ti, si]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def trace_paths_sharded(scene, cam_to_world: torch.Tensor, key=None, *,
                        mesh: Mesh, width: int, height: int,
                        bounces: int = 3, nee: bool = True,
                        vfov: float = 0.7853982,
                        jitter: Optional[torch.Tensor] = None,
                        nee_uv: Optional[torch.Tensor] = None,
                        noise_tex: Optional[torch.Tensor] = None,
                        frame_count: Optional[int] = None,
                        uniforms=None, sort_rays: bool = True):
    """The frame traced as row slabs over ``mesh``. Returns ``(radiance
    (H, W, 3), {plane: (H, W[, 3])})``, the G-buffer planes of
    ``GBUFFER_PLANES``, both on the mesh's first device.

    ``scene``: ``replicate_scene``'s copies, or one ``SceneBuffers``,
    which is copied to the mesh's devices first. Shard (ti, si) traces
    rows [ti * rows, (ti + 1) * rows), rows = height / n_tiles, one
    sample a pixel (as the reference's shards, whatever
    ``samples_per_frame`` says). The spp shards' radiance is summed in si
    order and divided by n_spp; the G-buffer is spp shard 0's.

    ``key``: the frame's entropy for ``shard_generator``; ``uniforms``: in
    its place, a [ti][si] nest of ``FrameUniforms`` of rows * width slots
    each (the tests replay the reference's folded keys with it).
    ``jitter`` / ``nee_uv`` (H * W, 2), pixel-major: full-frame
    blue-noise planes, cut into the shards' slabs. As in the reference,
    ``jitter`` turns the shards' blue noise on: without ``noise_tex``
    they draw from a (1, 1, 2) texture of zeros at frame 0.
    ``sort_rays``: as ``trace_paths``'.
    """
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    if height % n_tiles:
        raise ValueError(f"height {height} must divide by the mesh's "
                         f"{n_tiles} tiles")
    if key is None and uniforms is None:
        raise ValueError("trace_paths_sharded needs a key or uniforms")
    rows = height // n_tiles
    replicas = (scene if isinstance(scene, dict)
                else replicate_scene(scene, mesh))
    # The reference's shards take blue noise only with a jitter plane.
    if jitter is None:
        noise_tex = frame_count = None
    elif noise_tex is None:
        noise_tex = torch.zeros((1, 1, 2), dtype=torch.float32)
        frame_count = 0

    def slab(plane, ti, d):
        """Rows [ti * rows, (ti + 1) * rows) of a pixel-major plane."""
        if plane is None:
            return None
        n = rows * width
        return plane.reshape(-1, 2)[ti * n:(ti + 1) * n].to(d)

    # Every shard's work is issued before anything is read back.
    traced = []
    for ti in range(n_tiles):
        for si in range(n_spp):
            d = mesh.devices[ti, si]
            if uniforms is None:
                g, u = shard_generator(key, ti, si, d), None
            else:
                g, u = None, uniforms[ti][si].to(d)
            traced.append(trace_paths(
                replicas[d], cam_to_world, width, height, g,
                bounces=bounces, vfov=vfov, nee=nee, sort_rays=sort_rays,
                uniforms=u,
                jitter=slab(jitter, ti, d), nee_uv=slab(nee_uv, ti, d),
                noise_tex=None if noise_tex is None else noise_tex.to(d),
                frame_count=frame_count, row_offset=ti * rows, rows=rows))

    dev0 = mesh.devices[0, 0]
    slabs, gbufs = [], []
    for ti in range(n_tiles):
        shards = traced[ti * n_spp:(ti + 1) * n_spp]
        rad = shards[0][0].to(dev0)
        for r, _ in shards[1:]:
            rad = rad + r.to(dev0)
        slabs.append((rad / n_spp).reshape(rows, width, 3))
        gbufs.append(shards[0][1])

    def gather(name):
        x = torch.cat([getattr(g, name).to(dev0) for g in gbufs])
        return x.reshape(height, width, *x.shape[1:])

    return torch.cat(slabs), {name: gather(name) for name in GBUFFER_PLANES}


def render_frame_sharded(scene, state, cam_to_world: torch.Tensor,
                         world_to_screen: torch.Tensor,
                         accumulate_flag: bool, *, mesh: Mesh, width: int,
                         height: int, bounces: int, nee: bool, vfov: float,
                         mode: str = "pathtrace", atrous_iterations: int = 4,
                         key=None, uniforms=None, use_noise: bool = False,
                         sort_rays: bool = True):
    """``render_frame`` with the trace split over ``mesh``
    (``trace_paths_sharded``); the gathered frame then runs the same
    motion vectors and accumulation or A-SVGF on the mesh's first device,
    where ``state`` lives. ``key`` / ``uniforms`` / ``sort_rays``: as
    ``trace_paths_sharded``'s; ``use_noise``: the full frame's jitter
    (dimension 0) and bounce-0 light plane (dimension 1) from
    ``state.noise_tex``, every other draw from the slabs' planes."""
    from ..render.renderer import blue_noise_uv, finish_frame

    jitter = nee_uv = None
    if use_noise:
        fc = state.frame_count
        jitter = blue_noise_uv(state.noise_tex, fc, width, height, dim=0)
        nee_uv = blue_noise_uv(state.noise_tex, fc, width, height, dim=1)
    img, gbuf = trace_paths_sharded(
        scene, cam_to_world, key, mesh=mesh, width=width, height=height,
        bounces=bounces, nee=nee, vfov=vfov, jitter=jitter, nee_uv=nee_uv,
        noise_tex=state.noise_tex if use_noise else None,
        frame_count=state.frame_count if use_noise else None,
        uniforms=uniforms, sort_rays=sort_rays)
    gb = GBuffer(**{name: x.reshape(height * width, *x.shape[2:])
                    for name, x in gbuf.items()})
    return finish_frame(state, img, gb, world_to_screen, accumulate_flag,
                        width=width, height=height, mode=mode,
                        atrous_iterations=atrous_iterations)
