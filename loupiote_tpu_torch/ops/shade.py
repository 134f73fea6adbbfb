"""BSDF shading + next-event estimation (counterpart of
``loupiote_tpu/ops/shade.py``).

PBR metallic-roughness: a Lambert lobe weighted (1 - metallic)(1 - F) and
a GGX lobe with Smith G and Schlick F, sampled by visible normals; base
colour and metallic-roughness may come from the texture atlas. NEE takes
one quad-light sample and, where a probe is bound, one environment
sample, each MIS-weighted (power heuristic) against BSDF sampling; quad
lights are not in the BVH and BSDF rays hit them analytically, and the
probe lights every geometry miss. Every random number comes in as an
explicit (R,) tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .. import spans
from .env import env_pdf, eval_env, sample_env
from .intersect import T_FAR, Hit, occluded
from .raygen import norm3
from .sampling import (INV_PI, cosine_sample_hemisphere, dot3,
                       fresnel_schlick, ggx_d, luminance, orthonormal_basis,
                       power_heuristic, reflect, sample_ggx_vndf, smith_g1,
                       smith_g2, to_world)
from .sort import ray_sort_key, sort_order
from .texture import sample_atlas

EPS_OFFSET = 1e-3
MIN_ALPHA = 1e-3
# Shadow waves are traced in their own sort order past this BVH2 size
# (the same gate as the integrator's inter-bounce sort).
SORT_MIN_NODES = 16384


@dataclass
class Surface:
    """Decoded hit-point attributes."""

    pos: torch.Tensor  # (R,3)
    n_geom: torch.Tensor  # (R,3) geometric normal, facing the incoming ray
    n_shade: torch.Tensor  # (R,3) shading normal
    albedo: torch.Tensor  # (R,3)
    roughness: torch.Tensor  # (R,)
    metallic: torch.Tensor  # (R,)
    emission: torch.Tensor  # (R,3)
    inst_id: torch.Tensor  # (R,) int32 instance id


@dataclass
class BounceState:
    """Per-ray path state between bounces."""

    ro: torch.Tensor  # (R,3)
    rd: torch.Tensor  # (R,3)
    throughput: torch.Tensor  # (R,3)
    radiance: torch.Tensor  # (R,3)
    alive: torch.Tensor  # (R,) bool
    bsdf_pdf: torch.Tensor  # (R,) pdf of the dir that produced this ray
    use_mis: torch.Tensor  # (R,) bool: ray came from a MIS-aware BSDF sample

    def columns(self):
        return [getattr(self, f.name) for f in fields(self)]


def _rotate(m, x):
    """Per-ray (R, 3, 3) @ (R, 3)."""
    return (m * x[:, None, :]).sum(-1)


def decode_surface(scene, ro, rd, hit: Hit, textures: bool = True) -> Surface:
    """Interpolated attributes at each hit (miss rays read triangle 0 and
    are masked by the caller). ``textures``: multiply the base colour
    (sRGB) and roughness / metallic (the G and B channels) by the
    material's atlas textures; a material without one reads white."""
    tri = torch.clamp_min(hit.tri, 0).to(torch.int64)
    w = 1.0 - hit.u - hit.v
    b = (w[:, None], hit.u[:, None], hit.v[:, None])

    srow = scene.tri_shade[tri]  # (R, 20)
    n0, n1, n2 = srow[:, 0:3], srow[:, 3:6], srow[:, 6:9]
    # Material and instance ids are ints bitcast into columns 15-16:
    # read the bits.
    ids = scene.tri_shade.view(torch.int32)[tri, 15:17]
    mat = ids[:, 0].to(torch.int64)
    inst_id = ids[:, 1]
    ng = srow[:, 17:20]

    n = n0 * b[0] + n1 * b[1] + n2 * b[2]
    if getattr(scene, "inst_w2o", None) is not None and hit.inst is not None:
        # Two-level scenes hold object-space attributes: the winning
        # instance turns both normals to world space and names the
        # material (scene/instanced.py).
        inst = hit.inst.clamp_min(0).to(torch.int64)
        nm = scene.inst_nmat[inst]  # (R, 3, 3)
        n, ng = _rotate(nm, n), _rotate(nm, ng)
        ng = ng / torch.clamp_min(norm3(ng), 1e-12)[:, None]
        mat = scene.inst_mat_id[inst].to(torch.int64)
        inst_id = hit.inst
    n = n / torch.clamp_min(norm3(n), 1e-12)[:, None]

    # Two-sided: orient both normals against the incoming direction.
    ng = torch.where((dot3(ng, rd) > 0.0)[:, None], -ng, ng)
    n = torch.where((dot3(n, rd) > 0.0)[:, None], -n, n)

    mrow = scene.mat_pack[mat]  # (R, 11)
    albedo, rough, metal = mrow[:, 0:3], mrow[:, 4], mrow[:, 5]
    if textures:
        uv = (srow[:, 9:11] * b[0] + srow[:, 11:13] * b[1]
              + srow[:, 13:15] * b[2])
        tex_ids = scene.mat_pack.view(torch.int32)[mat, 9:11]
        tex_albedo = sample_atlas(scene, tex_ids[:, 0], uv, srgb=True)
        tex_mra = sample_atlas(scene, tex_ids[:, 1], uv, srgb=False)
        albedo = albedo * tex_albedo[:, :3]
        # glTF metallic-roughness: G = roughness, B = metallic.
        rough = rough * tex_mra[:, 1]
        metal = metal * tex_mra[:, 2]
    pos = ro + rd * hit.t[:, None]
    return Surface(pos=pos, n_geom=ng, n_shade=n, albedo=albedo,
                   roughness=rough, metallic=metal,
                   emission=mrow[:, 6:9], inst_id=inst_id)


def _spec_select_prob(surf: Surface, n_dot_o):
    """Probability of sampling the specular lobe (Fresnel-luminance based)."""
    f0 = (0.04 * (1.0 - surf.metallic[:, None])
          + surf.albedo * surf.metallic[:, None])
    f_avg = luminance(fresnel_schlick(torch.clamp_min(n_dot_o, 0.0), f0))
    d_avg = luminance(surf.albedo) * (1.0 - surf.metallic)
    return torch.clamp(f_avg / torch.clamp_min(f_avg + d_avg, 1e-6),
                       0.05, 0.95)


def bsdf_eval_pdf(surf: Surface, wo, wi):
    """f(wo, wi) (R,3) and pdf (R,); zero below the shading hemisphere."""
    n = surf.n_shade
    n_dot_o = dot3(n, wo)
    n_dot_i = dot3(n, wi)
    valid = (n_dot_i > 0.0) & (n_dot_o > 0.0)

    h = wo + wi
    h = h / torch.clamp_min(norm3(h), 1e-12)[:, None]
    n_dot_h = torch.clamp(dot3(n, h), 0.0, 1.0)
    o_dot_h = torch.clamp(dot3(wo, h), 1e-6, 1.0)

    alpha = torch.clamp_min(surf.roughness * surf.roughness, MIN_ALPHA)
    f0 = (0.04 * (1.0 - surf.metallic[:, None])
          + surf.albedo * surf.metallic[:, None])
    F = fresnel_schlick(o_dot_h, f0)
    D = ggx_d(n_dot_h, alpha)
    G = smith_g2(n_dot_o, n_dot_i, alpha)

    spec = F * (D * G / torch.clamp_min(4.0 * n_dot_o * n_dot_i,
                                        1e-9))[:, None]
    kd = (1.0 - surf.metallic)[:, None] * (1.0 - F)
    diff = kd * surf.albedo * INV_PI
    f = torch.where(valid[:, None], diff + spec, 0.0)

    p_spec = _spec_select_prob(surf, n_dot_o)
    pdf_spec = smith_g1(n_dot_o, alpha) * D / torch.clamp_min(4.0 * n_dot_o,
                                                              1e-9)
    pdf_diff = torch.clamp_min(n_dot_i, 0.0) * INV_PI
    pdf = torch.where(valid, p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff,
                      0.0)
    return f, pdf


def sample_bsdf(surf: Surface, wo, u_lobe, u1, u2):
    """Sample wi from the BSDF. Returns (wi, f, pdf)."""
    n = surf.n_shade
    t, bt = orthonormal_basis(n)
    n_dot_o = dot3(n, wo)
    wo_local = torch.stack([dot3(t, wo), dot3(bt, wo), n_dot_o], dim=1)

    alpha = torch.clamp_min(surf.roughness * surf.roughness, MIN_ALPHA)
    p_spec = _spec_select_prob(surf, n_dot_o)

    h_local = sample_ggx_vndf(wo_local, alpha, u1, u2)
    wi_spec = reflect(-wo, to_world(n, t, bt, h_local))
    wi_diff = to_world(n, t, bt, cosine_sample_hemisphere(u1, u2))

    wi = torch.where((u_lobe < p_spec)[:, None], wi_spec, wi_diff)
    f, pdf = bsdf_eval_pdf(surf, wo, wi)
    return wi, f, pdf


def scene_exit_t(scene, ro, rd):
    """Distance at which each ray leaves the root AABB (plus a margin)."""
    lo = scene.node_min[0]
    hi = scene.node_max[0]
    inv = 1.0 / torch.where(rd.abs() > 1e-20, rd,
                            torch.where(rd >= 0, 1e-20, -1e-20))
    t1 = (lo - ro) * inv
    t2 = (hi - ro) * inv
    tfar = torch.amin(torch.maximum(t1, t2), dim=1)
    return torch.clamp_min(tfar, 0.0) * 1.001 + 1e-2


def intersect_lights(scene, ro, rd, t_geo):
    """Analytic ray-vs-quad-light test against all lights.

    Returns (radiance_hit (R,3), pdf_area_sa (R,), t (R,), hit_any (R,))
    for the nearest light in front of the geometry hit distance ``t_geo``.
    """
    R = ro.shape[0]
    dev = ro.device
    best_t = torch.full((R,), T_FAR, dtype=torch.float32, device=dev)
    best_emit = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    best_pdf = torch.zeros(R, dtype=torch.float32, device=dev)
    nl = max(scene.num_lights, 0)
    for li in range(nl):
        o = scene.light_origin[li]
        eu = scene.light_eu[li]
        ev = scene.light_ev[li]
        nrm = torch.stack([eu[1] * ev[2] - eu[2] * ev[1],
                           eu[2] * ev[0] - eu[0] * ev[2],
                           eu[0] * ev[1] - eu[1] * ev[0]])
        area = torch.sqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2])
        nrm_u = nrm / torch.clamp_min(area, 1e-12)
        denom = dot3(rd, nrm_u[None, :])
        t = dot3(o[None, :] - ro, nrm_u[None, :]) / torch.where(
            denom.abs() > 1e-9, denom, 1e-9)
        p = ro + rd * t[:, None]
        rel = p - o
        # Project onto the (possibly non-orthogonal) edge basis.
        uu = eu[0] * eu[0] + eu[1] * eu[1] + eu[2] * eu[2]
        vv = ev[0] * ev[0] + ev[1] * ev[1] + ev[2] * ev[2]
        uv_ = eu[0] * ev[0] + eu[1] * ev[1] + eu[2] * ev[2]
        pu = dot3(rel, eu[None, :])
        pv = dot3(rel, ev[None, :])
        det = uu * vv - uv_ * uv_
        a = (pu * vv - pv * uv_) / torch.clamp_min(det, 1e-12)
        b = (pv * uu - pu * uv_) / torch.clamp_min(det, 1e-12)
        inside = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        ok = (inside & (t > 1e-4) & (t < t_geo) & (t < best_t)
              & (denom.abs() > 1e-9))
        # Solid-angle pdf of NEE having produced this direction.
        cos_l = denom.abs()
        pdf_sa = (t * t) / torch.clamp_min(cos_l * area, 1e-9) / max(nl, 1)
        best_emit = torch.where(ok[:, None], scene.light_emission[li],
                                best_emit)
        best_pdf = torch.where(ok, pdf_sa, best_pdf)
        best_t = torch.where(ok, t, best_t)
    return best_emit, best_pdf, best_t, best_t < T_FAR


def sample_light(scene, surf_pos, u_sel, u1, u2):
    """NEE: a point on a uniformly chosen quad light.

    Returns (wi (R,3), dist (R,), emitted (R,3), pdf_sa (R,)).
    """
    nl = max(scene.num_lights, 1)
    li = torch.clamp_max((u_sel * nl).to(torch.int64), nl - 1)
    o = scene.light_origin[li]
    eu = scene.light_eu[li]
    ev = scene.light_ev[li]
    emit = scene.light_emission[li]
    q = o + eu * u1[:, None] + ev * u2[:, None]
    nrm = torch.stack([eu[:, 1] * ev[:, 2] - eu[:, 2] * ev[:, 1],
                       eu[:, 2] * ev[:, 0] - eu[:, 0] * ev[:, 2],
                       eu[:, 0] * ev[:, 1] - eu[:, 1] * ev[:, 0]], dim=1)
    area = norm3(nrm)
    nrm_u = nrm / torch.clamp_min(area[:, None], 1e-12)

    delta = q - surf_pos
    dist = norm3(delta)
    wi = delta / torch.clamp_min(dist[:, None], 1e-12)
    cos_l = dot3(nrm_u, -wi).abs()  # two-sided emitter
    pdf_sa = (dist * dist) / torch.clamp_min(cos_l * area, 1e-9) / nl
    return wi, dist, emit, pdf_sa


def _occluded_sorted(scene, o, d, dist, active):
    """Run an occlusion wave in its own octant+Morton order, then return
    the blocked bits to the caller's order with one scatter."""
    order = sort_order(ray_sort_key(o, d, active, scene.node_min[0],
                                    scene.node_max[0]))
    mat = torch.cat([o, d, dist[:, None], active.to(torch.float32)[:, None]],
                    dim=1)[order]
    blocked_s = occluded(scene, mat[:, 0:3], mat[:, 3:6], mat[:, 6],
                         active=mat[:, 7] > 0)
    out = torch.zeros_like(blocked_s)
    out[order] = blocked_s
    return out


def _shadow(scene, o, d, dist, active):
    # The span lets a frame's trace split the shadow waves out of the
    # shading label (app/trace_parse.py).
    with spans.span("shadow"):
        spans.rays(active)
        if scene.num_nodes > SORT_MIN_NODES:
            return _occluded_sorted(scene, o, d, dist, active)
        return occluded(scene, o, d, dist, active=active)


def shade_step(scene, state: BounceState, hit: Hit, *, u_sel, u1_l, u2_l,
               u_lobe, u1, u2, u1_e=None, u2_e=None, nee: bool = True,
               last: bool = False):
    """Advance every ray one bounce. Returns the new BounceState.

    ``u_sel``: light selection; ``u1_l``, ``u2_l``: the point on the
    light; ``u_lobe``: lobe selection; ``u1``, ``u2``: the BSDF sample;
    ``u1_e``, ``u2_e``: the environment sample (needed with a probe and
    NEE). Each is an (R,) tensor of uniforms in slot order.

    ``last``: the path's final vertex. Its continuation ray is not traced
    against geometry; a final gather tests it against the light quads and,
    with a probe, the environment (to the scene's exit) with one any-hit
    query, so every MIS pair stays complete.
    """
    ro, rd = state.ro, state.rd
    alive = state.alive
    miss = (hit.tri < 0) & alive
    hit_geo = (hit.tri >= 0) & alive
    radiance = state.radiance
    throughput = state.throughput

    # Light quads are invisible to the BVH: test them analytically.
    l_emit, l_pdf, _, l_hit = intersect_lights(scene, ro, rd, hit.t)
    w_light = torch.where(state.use_mis & nee,
                          power_heuristic(state.bsdf_pdf, l_pdf), 1.0)
    radiance = radiance + torch.where((l_hit & alive)[:, None],
                                      throughput * l_emit * w_light[:, None],
                                      0.0)

    if scene.has_probe:  # the environment on a geometry miss
        w_env = torch.where(state.use_mis,
                            power_heuristic(state.bsdf_pdf,
                                            env_pdf(scene, rd)), 1.0)
        radiance = radiance + torch.where(
            miss[:, None], throughput * eval_env(scene, rd) * w_env[:, None],
            0.0)

    surf = decode_surface(scene, ro, rd, hit, textures=scene.has_textures)
    wo = -rd
    # Emissive surfaces (no NEE on emissive triangles: full weight).
    radiance = radiance + torch.where(hit_geo[:, None],
                                      throughput * surf.emission, 0.0)

    if nee and scene.num_lights > 0:
        wi_l, dist_l, emit_l, pdf_l = sample_light(scene, surf.pos, u_sel,
                                                   u1_l, u2_l)
        f_l, pdf_b_l = bsdf_eval_pdf(surf, wo, wi_l)
        cos_i = torch.clamp_min(dot3(surf.n_shade, wi_l), 0.0)
        contrib_mask = (hit_geo & (pdf_l > 0) & (cos_i > 0)
                        & (luminance(f_l) > 0))
        shadow_o = surf.pos + surf.n_geom * EPS_OFFSET
        blocked = _shadow(scene, shadow_o, wi_l, dist_l, contrib_mask)
        w = power_heuristic(pdf_l, pdf_b_l)
        contrib = throughput * f_l * emit_l * (
            cos_i * w / torch.clamp_min(pdf_l, 1e-12))[:, None]
        radiance = radiance + torch.where((contrib_mask & ~blocked)[:, None],
                                          contrib, 0.0)

    if nee and scene.has_probe:
        # One environment sample, its shadow ray out to the scene's exit.
        wi_e, pdf_e = sample_env(scene, u1_e, u2_e)
        f_e, pdf_b_e = bsdf_eval_pdf(surf, wo, wi_e)
        cos_e = torch.clamp_min(dot3(surf.n_shade, wi_e), 0.0)
        mask_e = hit_geo & (pdf_e > 0) & (cos_e > 0) & (luminance(f_e) > 0)
        shadow_o = surf.pos + surf.n_geom * EPS_OFFSET
        blocked_e = _shadow(scene, shadow_o, wi_e,
                            scene_exit_t(scene, shadow_o, wi_e), mask_e)
        w_e = power_heuristic(pdf_e, pdf_b_e)
        contrib_e = throughput * f_e * eval_env(scene, wi_e) * (
            cos_e * w_e / torch.clamp_min(pdf_e, 1e-12))[:, None]
        radiance = radiance + torch.where((mask_e & ~blocked_e)[:, None],
                                          contrib_e, 0.0)

    # Sample the BSDF for the continuation ray.
    wi, f, pdf = sample_bsdf(surf, wo, u_lobe, u1, u2)
    cos_n = dot3(surf.n_shade, wi)
    ok = (hit_geo & (pdf > 1e-12) & (cos_n > 0)
          & (dot3(surf.n_geom, wi) > 0))
    new_throughput = throughput * f * (
        torch.clamp_min(cos_n, 0.0) / torch.clamp_min(pdf, 1e-12))[:, None]

    if last:
        gro = surf.pos + surf.n_geom * EPS_OFFSET
        g_emit, g_pdf, g_t, g_lhit = intersect_lights(
            scene, gro, wi, torch.full_like(pdf, T_FAR))
        if scene.has_probe:  # tested to the light, else to the exit
            g_blocked = _shadow(scene, gro, wi,
                                torch.where(g_lhit, g_t,
                                            scene_exit_t(scene, gro, wi)), ok)
        else:
            g_blocked = _shadow(scene, gro, wi, g_t, ok & g_lhit)
        w_gl = power_heuristic(pdf, g_pdf) if nee else torch.ones_like(pdf)
        add_l = ok & g_lhit & ~g_blocked
        radiance = radiance + torch.where(
            add_l[:, None], new_throughput * g_emit * w_gl[:, None], 0.0)
        if scene.has_probe:
            w_ge = (power_heuristic(pdf, env_pdf(scene, wi)) if nee
                    else torch.ones_like(pdf))
            radiance = radiance + torch.where(
                (ok & ~g_blocked)[:, None],
                new_throughput * eval_env(scene, wi) * w_ge[:, None], 0.0)
        return BounceState(ro=ro, rd=rd, throughput=throughput,
                           radiance=radiance,
                           alive=torch.zeros_like(alive),
                           bsdf_pdf=state.bsdf_pdf, use_mis=state.use_mis)

    new_ro = torch.where(ok[:, None], surf.pos + surf.n_geom * EPS_OFFSET, ro)
    new_rd = torch.where(ok[:, None], wi, rd)
    new_throughput = torch.where(ok[:, None], new_throughput, throughput)
    bsdf_pdf = torch.where(ok, pdf, state.bsdf_pdf)
    with spans.sync("nee"):
        nee_t = torch.tensor(nee, device=ok.device)
    return BounceState(ro=new_ro, rd=new_rd, throughput=new_throughput,
                       radiance=radiance, alive=ok, bsdf_pdf=bsdf_pdf,
                       use_mis=torch.where(ok, nee_t, state.use_mis))
