"""Path-tracing integrator: raygen -> [sort -> intersect -> shade] x bounces
(counterpart of ``loupiote_tpu/render/integrator.py``, one sample per
pixel, pseudo-random numbers).

Random numbers come from an explicit ``torch.Generator``. ``FrameUniforms``
holds every draw of a frame, so a caller can supply its own, as the tests
do to replay the reference's ``jax.random`` streams.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, NamedTuple, Optional

import torch

from ..ops.intersect import intersect_any
from ..ops.raygen import generate_rays
from ..ops.shade import (SORT_MIN_NODES, BounceState, decode_surface,
                         shade_step)
from ..ops.sort import ray_sort_key, sort_order

# Pixel tile that groups rays into spatially coherent runs: 8 rows x 128.
TILE_H, TILE_W = 8, 128


def _tiles_ok(width: int, rows: int) -> bool:
    return width % TILE_W == 0 and rows % TILE_H == 0


def to_tile_order(x: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    """Pixel-major (R, ...) -> tile-major, as a reshape/transpose."""
    lead = x.shape[1:]
    x = x.reshape(rows // TILE_H, TILE_H, width // TILE_W, TILE_W, *lead)
    return x.transpose(1, 2).reshape(rows * width, *lead)


def from_tile_order(x: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    lead = x.shape[1:]
    x = x.reshape(rows // TILE_H, width // TILE_W, TILE_H, TILE_W, *lead)
    return x.transpose(1, 2).reshape(rows * width, *lead)


class GBuffer(NamedTuple):
    """First-bounce aux output, pixel order (the reference's GBuffer)."""

    normal: torch.Tensor  # (R,3) shading normal (0 on a miss)
    depth: torch.Tensor  # (R,) hit distance (T_FAR on a miss)
    mesh_id: torch.Tensor  # (R,) int32 instance id (-1 on a miss)
    albedo: torch.Tensor  # (R,3) surface albedo (1 on a miss)
    world_pos: torch.Tensor  # (R,3) hit position, for motion vectors


@dataclass
class BounceUniforms:
    """One bounce's draws, (N,) each, in the bounce's slot order."""

    u_sel: torch.Tensor  # light selection
    u1_l: torch.Tensor  # point on the light
    u2_l: torch.Tensor
    u_lobe: torch.Tensor  # BSDF lobe selection
    u1: torch.Tensor  # BSDF sample
    u2: torch.Tensor


@dataclass
class FrameUniforms:
    """Every random number of one frame."""

    jitter: torch.Tensor  # (N, 2) sub-pixel offsets, pixel order
    bounces: List[BounceUniforms]

    def to(self, device) -> "FrameUniforms":
        return FrameUniforms(self.jitter.to(device), [
            BounceUniforms(*(getattr(b, f.name).to(device)
                             for f in fields(b))) for b in self.bounces])


def draw_uniforms(n: int, bounces: int, generator: torch.Generator,
                  device) -> FrameUniforms:
    """Draw a frame's uniforms in [0, 1) from ``generator``."""
    def u(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    jitter = u(n, 2)
    return FrameUniforms(jitter, [BounceUniforms(u(n), u(n), u(n), u(n),
                                                 u(n), u(n))
                                  for _ in range(bounces)])


def _permute_packed(state: BounceState, pid: torch.Tensor,
                    order: torch.Tensor):
    """Apply the sort permutation as two row gathers: one of the packed
    float32 columns, one of the bool columns (as int32) plus ``pid``."""
    fcols, icols = [], []
    for x in state.columns():
        col = x.reshape(x.shape[0], -1)
        if x.dtype == torch.float32:
            fcols.append(col)
        else:
            icols.append(col.to(torch.int32))
    icols.append(pid[:, None])
    fmat = torch.cat(fcols, dim=1)[order]
    imat = torch.cat(icols, dim=1)[order]
    out, fo, io = [], 0, 0
    for x in state.columns():
        w = x[0].numel()
        if x.dtype == torch.float32:
            col = fmat[:, fo:fo + w]
            fo += w
        else:
            assert x.dtype == torch.bool, x.dtype
            col = imat[:, io:io + w] != 0
            io += w
        out.append(col.reshape(x.shape))
    return BounceState(*out), imat[:, io]


def trace_paths(scene, cam_to_world: torch.Tensor, width: int, height: int,
                generator: Optional[torch.Generator] = None,
                bounces: int = 3, vfov: float = 0.7853982, nee: bool = True,
                sort_rays: bool = True,
                uniforms: Optional[FrameUniforms] = None):
    """Trace one sample per pixel. Returns ``(radiance, gbuffer)``:
    radiance (height * width, 3) and the bounce-0 ``GBuffer``, both
    pixel-major.

    ``sort_rays``: between bounces, permute the whole bounce state into
    direction-octant + origin-Morton order (scenes past ``SORT_MIN_NODES``
    BVH2 nodes), and scatter the radiance back to pixel order at the end.
    ``uniforms``: the frame's random numbers; drawn from ``generator``
    when None.
    """
    if scene.has_probe or scene.has_textures:
        raise NotImplementedError(
            "probe and textured scenes come with a later slice of the port")
    dev = scene.device
    N = width * height
    if uniforms is None:
        if generator is None:
            raise ValueError("trace_paths needs a generator or uniforms")
        uniforms = draw_uniforms(N, bounces, generator, dev)
    tiled = _tiles_ok(width, height)

    def tile(x):
        return to_tile_order(x, width, height) if tiled else x

    ro, rd = generate_rays(cam_to_world.to(dev, torch.float32), width, height,
                           vfov, uniforms.jitter)
    state = BounceState(
        ro=tile(ro).contiguous(), rd=tile(rd).contiguous(),
        throughput=torch.ones((N, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((N, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        bsdf_pdf=torch.zeros(N, dtype=torch.float32, device=dev),
        use_mis=torch.zeros(N, dtype=torch.bool, device=dev))

    do_sort = sort_rays and scene.num_nodes > SORT_MIN_NODES
    lo, hi = scene.node_min[0], scene.node_max[0]
    pid = torch.arange(N, dtype=torch.int32, device=dev)  # slot -> pixel slot
    for bounce in range(bounces):
        if do_sort and bounce > 0:
            key = ray_sort_key(state.ro, state.rd, state.alive, lo, hi)
            state, pid = _permute_packed(state, pid, sort_order(key))
        hit = intersect_any(scene, state.ro, state.rd, active=state.alive)
        if bounce == 0:
            surf = decode_surface(scene, state.ro, state.rd, hit)
            missed = hit.tri < 0
            gbuffer = GBuffer(
                normal=torch.where(missed[:, None], 0.0, surf.n_shade),
                depth=hit.t,
                mesh_id=torch.where(missed, -1, surf.inst_id),
                albedo=torch.where(missed[:, None], 1.0, surf.albedo),
                world_pos=surf.pos)
        u = uniforms.bounces[bounce]
        state = shade_step(scene, state, hit, u_sel=u.u_sel, u1_l=u.u1_l,
                           u2_l=u.u2_l, u_lobe=u.u_lobe, u1=u.u1, u2=u.u2,
                           nee=nee, last=(bounce == bounces - 1))

    radiance = state.radiance
    if do_sort:
        out = torch.zeros_like(radiance)
        out[pid.to(torch.int64)] = radiance
        radiance = out
    if tiled:
        radiance = from_tile_order(radiance, width, height)
        gbuffer = GBuffer(*(from_tile_order(f, width, height)
                            for f in gbuffer))
    return radiance, gbuffer


def accumulate(accum: torch.Tensor, sample: torch.Tensor,
               frame_count: int) -> torch.Tensor:
    """Progressive running average: lerp(accum, sample, 1/frame_count)."""
    w = 1.0 / max(float(frame_count), 1.0)
    return accum + (sample - accum) * w
