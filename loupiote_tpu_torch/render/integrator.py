"""Path-tracing integrator: raygen -> [sort -> intersect -> shade] x bounces
(counterpart of ``loupiote_tpu/render/integrator.py``).

``spp`` samples per pixel go through each wave together, sample-major
(slot s * R + tile pixel). Random numbers come from an explicit
``torch.Generator``; ``FrameUniforms`` holds every pseudo-random draw of
a frame, so a caller can supply its own, as the tests do to replay the
reference's ``jax.random`` streams. With a blue-noise texture the jitter,
the bounce-0 light sample and every bounce's BSDF and lobe draws come
from its rotated planes instead (``renderer.blue_noise_uv``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..ops.intersect import Hit, intersect_any
from ..ops.raygen import generate_rays
from ..ops.sampling import FrameUniforms, draw_uniforms
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
                uniforms: Optional[FrameUniforms] = None,
                jitter: Optional[torch.Tensor] = None,
                nee_uv: Optional[torch.Tensor] = None,
                noise_tex: Optional[torch.Tensor] = None,
                frame_count: Optional[int] = None, spp: int = 1,
                row_offset: int = 0, rows: Optional[int] = None):
    """Trace ``spp`` samples per pixel in one wave. Returns
    ``(radiance, gbuffer)``: radiance (rows * width, 3), the mean of the
    samples, and the ``GBuffer`` of sample 0, both pixel-major.

    ``row_offset`` / ``rows``: trace only the row slab [row_offset,
    row_offset + rows) of the height-row image (``rows`` None: every
    row), the unit of tile parallelism (``parallel/tiles.py`` gives each
    shard its slab). Everything per pixel is the slab's: R = rows *
    width slots, the 8 x 128 tile order when ``rows`` is a multiple of 8,
    the blue-noise planes of its rows.

    ``sort_rays``: between bounces, permute the whole bounce state into
    direction-octant + origin-Morton order (scenes past ``SORT_MIN_NODES``
    BVH2 nodes), and return the radiance to slot order at the end.
    ``uniforms``: the frame's pseudo-random numbers, (spp * R,) each;
    drawn from ``generator`` when None.
    ``jitter`` (R or spp * R, 2) and ``nee_uv`` (R, 2, pixel order): the
    sub-pixel offsets and the bounce-0 light sample, in place of the
    uniforms'.
    ``noise_tex`` (Hn, Wn, 2) and ``frame_count``: every light, BSDF and
    lobe draw comes from blue noise, dimension ``1 + 3 * bounce`` for the
    light, ``2 + 3 * bounce`` for the BSDF and ``3 + 3 * bounce`` for the
    lobe, each plane rotated for its frame; with ``spp`` > 1, sample s
    draws every dimension, the jitter (dimension 0) included, at the
    effective frame ``frame_count * spp + s``.
    """
    from .renderer import blue_noise_uv

    dev = scene.device
    if rows is None:
        rows = height
    R = width * rows
    N = spp * R
    if uniforms is None:
        if generator is None:
            raise ValueError("trace_paths needs a generator or uniforms")
        uniforms = draw_uniforms(N, bounces, generator, dev,
                                 env=scene.has_probe)
    tiled = _tiles_ok(width, rows)
    noise = noise_tex is not None

    def tile(x):
        return to_tile_order(x, width, rows) if tiled else x

    def bn(dim):
        """Blue-noise plane ``dim`` of each sample, slot order."""
        return torch.cat([tile(blue_noise_uv(
            noise_tex, frame_count * spp + s if spp > 1 else frame_count,
            width, height, dim=dim, row_offset=row_offset, rows=rows))
            for s in range(spp)])

    # Each stage runs under a named range (the reference's tokens), so
    # a frame's trace attributes its kernels by pass (app/trace_parse.py).
    with record_function("raygen"):
        if spp > 1 and noise:
            # Each sample its own jitter: tiling one plane would trace every
            # primary ray spp times.
            jitter = torch.cat([blue_noise_uv(noise_tex, frame_count * spp + s,
                                              width, height, dim=0,
                                              row_offset=row_offset,
                                              rows=rows)
                                for s in range(spp)])
            nee_uv = None  # bn(1) per sample at bounce 0
        elif jitter is None:
            jitter = uniforms.jitter
        elif jitter.shape[0] != N:
            jitter = jitter.repeat(spp, 1)
        cam = cam_to_world.to(dev, torch.float32)
        ros, rds = [], []
        for s in range(spp):
            ro, rd = generate_rays(cam, width, height, vfov,
                                   jitter[s * R:(s + 1) * R],
                                   row_offset=row_offset, rows=rows)
            ros.append(tile(ro))
            rds.append(tile(rd))
        if nee_uv is not None:
            nee_uv = tile(nee_uv).repeat(spp, 1)
        state = BounceState(
            ro=torch.cat(ros).contiguous(), rd=torch.cat(rds).contiguous(),
            throughput=torch.ones((N, 3), dtype=torch.float32, device=dev),
            radiance=torch.zeros((N, 3), dtype=torch.float32, device=dev),
            alive=torch.ones(N, dtype=torch.bool, device=dev),
            bsdf_pdf=torch.zeros(N, dtype=torch.float32, device=dev),
            use_mis=torch.zeros(N, dtype=torch.bool, device=dev))
        del ros, rds

    do_sort = sort_rays and scene.num_nodes > SORT_MIN_NODES
    lo, hi = scene.node_min[0], scene.node_max[0]
    pid = torch.arange(N, dtype=torch.int32, device=dev)  # slot -> pixel slot
    for bounce in range(bounces):
        if do_sort and bounce > 0:
            with record_function(f"sortb{bounce}"):
                key = ray_sort_key(state.ro, state.rd, state.alive, lo, hi)
                state, pid = _permute_packed(state, pid, sort_order(key))
        with record_function(f"intersect{bounce}"):
            hit = intersect_any(scene, state.ro, state.rd,
                                active=state.alive)
        if bounce == 0:
            with record_function("gbuffer"):
                # Sample 0's slots, [:R]: bounce 0 is not sorted.
                hit0 = Hit(*(None if x is None else x[:R] for x in hit))
                surf = decode_surface(scene, state.ro[:R], state.rd[:R],
                                      hit0, textures=scene.has_textures)
                missed = hit0.tri < 0
                gbuffer = GBuffer(
                    normal=torch.where(missed[:, None], 0.0, surf.n_shade),
                    depth=hit0.t,
                    mesh_id=torch.where(missed, -1, surf.inst_id),
                    albedo=torch.where(missed[:, None], 1.0, surf.albedo),
                    world_pos=surf.pos)
                del surf
        u = uniforms.bounces[bounce]
        u1_l, u2_l, u_lobe, u1, u2 = u.u1_l, u.u2_l, u.u_lobe, u.u1, u.u2
        light_uv = nee_uv if bounce == 0 else None
        if noise:
            # One packed (N, 5) gather takes the bounce's planes through
            # the sort permutation (planes are in pixel slots, pid maps
            # each slot to its pixel slot).
            cols = [bn(1 + 3 * bounce)] if light_uv is None else []
            cols += [bn(2 + 3 * bounce), bn(3 + 3 * bounce)[:, :1]]
            mat = torch.cat(cols, dim=1)
            if do_sort and bounce > 0:
                mat = mat[pid.to(torch.int64)]
            if light_uv is None:
                light_uv, mat = mat[:, 0:2], mat[:, 2:]
            u1, u2, u_lobe = mat[:, 0], mat[:, 1], mat[:, 2]
        if light_uv is not None:
            u1_l, u2_l = light_uv[:, 0], light_uv[:, 1]
        with record_function(f"shade{bounce}"):
            state = shade_step(scene, state, hit, u_sel=u.u_sel, u1_l=u1_l,
                               u2_l=u2_l, u_lobe=u_lobe, u1=u1, u2=u2,
                               u1_e=u.u1_e, u2_e=u.u2_e, nee=nee,
                               last=(bounce == bounces - 1))
        del hit

    radiance = state.radiance
    if do_sort:
        out = torch.zeros_like(radiance)
        out[pid.to(torch.int64)] = radiance
        radiance = out
    if spp > 1:
        # Slot s * R + p holds pixel p's sample s: sum the samples in
        # order (a deterministic sum, unlike a scatter-add's atomics).
        radiance = radiance.reshape(spp, R, 3).sum(dim=0) / spp
    if tiled:
        radiance = from_tile_order(radiance, width, rows)
        gbuffer = GBuffer(*(from_tile_order(f, width, rows)
                            for f in gbuffer))
    return radiance, gbuffer


def accumulate(accum: torch.Tensor, sample: torch.Tensor,
               frame_count: int) -> torch.Tensor:
    """Progressive running average: lerp(accum, sample, 1/frame_count)."""
    w = 1.0 / max(float(frame_count), 1.0)
    return accum + (sample - accum) * w
