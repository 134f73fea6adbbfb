#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (loupiote_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed:
  1. device    - require CUDA; print the card and its power limit;
  2. build     - compile the traversal kernels (nvcc, one process per
                 source, in parallel) and the BVH builder (g++);
  3. K1        - kernel K1 (csrc/wide_traverse.cu) against its plain torch
                 twin on the card, closest-hit and any-hit, on a random
                 4k-triangle scene, the arch-260k primary wave at 1080p and
                 a sorted diffuse wave; K1's time on the 1080p waves;
  4. K2/K3     - kernels K2 and K3 (csrc/bvh2_traverse.cu) against their
                 twins on the random-4k scene, the arch-40k 960x540 primary
                 wave with its NEE wave and an arch-40k diffuse wave; K2,
                 K3 and K1 times on the same arch-40k waves;
  5. headline  - arch-260k at 1920x1080, 3 bounces, NEE, 1 spp, pathtrace,
                 through Renderer.set_resources -> raytrace -> blit, with
                 the kernels' launch counts read around it, and a small
                 frame held against the same frame traced by the CPU path;
  6. interactive - arch-40k in a 1920x1080 window with RenderConfig()
                 (960x540 internal, 3 bounces, NEE, A-SVGF) and
                 DENOISED_PATHTRACE, the camera moving every frame, with
                 the launch counts read around it; A-SVGF timed alone;
                 every blit mode; a small denoised frame pair on the card
                 held against the CPU path.
Any disagreement or failure raises, so the run exits non-zero without its
last line. Prints a JSON line of kernel results, then the card's nvidia-smi
line, then {"ok": true, "device": {...}} as the last line.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

WIDTH, HEIGHT, BOUNCES = 1920, 1080, 3
SUBSET = 65_536  # rays the plain traversals replay of each full wave
# Bounds: H100 SXM peaks (HBM3 rate and dense FP32 rate), float32 outside the
# tensor cores, and the float operations of one box test (6 sub, 6 mul,
# 6 min/max of the slab pairs, 4 to combine, the clamp and 2 compares) and
# of one Moller-Trumbore test (46 arithmetic, 7 compares).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
OPS_BOX, OPS_TRI = 25, 53
RAY_IN_BYTES = 12 + 12 + 4 + 1  # ro, rd, tmax, active


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_rays, out_bytes, table_bytes, ops):
    """(ms, which): the larger of the bytes over the memory rate and the
    operations over the float32 rate."""
    b_ms = (n_rays * (RAY_IN_BYTES + out_bytes) + table_bytes) / PEAK_BYTES_S
    o_ms = ops / PEAK_FLOP_S
    return (max(b_ms, o_ms) * 1e3,
            "bytes" if b_ms >= o_ms else "operations")


def ulp_diff(a, b):
    import torch

    return (a.view(torch.int32).to(torch.int64)
            - b.view(torch.int32).to(torch.int64)).abs()


def tri_t(scene, ro, rd, tri):
    """t of triangle ``tri`` along each ray (Moller-Trumbore), -1 -> inf."""
    import torch

    from loupiote_tpu_torch.ops.intersect import moller_trumbore

    trow = scene.tri_pack[tri.clamp_min(0).long()]
    _, _, t = moller_trumbore((ro[:, 0], ro[:, 1], ro[:, 2]),
                              (rd[:, 0], rd[:, 1], rd[:, 2]),
                              tuple(trow[:, j] for j in range(9)))
    return torch.where(tri >= 0, t, float("inf"))


def strided(R, device):
    import torch

    return torch.arange(0, R, max(R // SUBSET, 1), device=device)[:SUBSET]


def hits_agree(scene, ro, rd, kt, ktri, pt, ptri):
    """(tri agree, ties, max t ulp, same) of two closest-hit results:
    a tri mismatch counts as a tie where both triangles lie within 2 ulp
    along the ray."""
    same = ktri == ptri
    tie = ~same & (ulp_diff(tri_t(scene, ro, rd, ktri),
                            tri_t(scene, ro, rd, ptri)) <= 2)
    agree = float((same | tie).float().mean())
    max_ulp = int(ulp_diff(kt[same], pt[same]).max()) if same.any() else 0
    return agree, int(tie.sum()), max_ulp, same


def compare_wide(name, scene, closest, shadow, rows, stats=None):
    """K1 against wide_trace_plain on one wave in both modes.

    ``closest``: (ro, rd, active); ``shadow``: (ro, rd, tmax, active). The
    kernel runs on the whole wave; the plain version on SUBSET rays of it
    (evenly strided), where the two are compared. ``stats``: receives the
    twin's work counts, by mode. Returns (ok, max |t| error, max |blocked|
    error) over the compared rays.
    """
    import torch

    from loupiote_tpu_torch.ops import wide

    ro, rd, active = closest
    R = ro.shape[0]
    idx = strided(R, ro.device)
    tfar = torch.full((R,), 1e30, device=ro.device)
    table = (scene.trav_rows,)
    sizes = (scene.wide_end, scene.wide_stack)
    kt, ktri = wide.wide_trace(*table, ro, rd, tfar, active, False, *sizes)
    kb = wide.wide_trace(*table, *shadow, True, *sizes)[1]
    sub = [x[idx].contiguous() for x in (ro, rd, tfar, active)]
    stats = {} if stats is None else stats
    pt, ptri = wide.wide_trace_plain(*table, *sub, False, *sizes,
                                     stats=stats.setdefault("closest", {}))
    pb = wide.wide_trace_plain(*table, *(x[idx].contiguous()
                                         for x in shadow), True, *sizes,
                               stats=stats.setdefault("anyhit", {}))[1]
    torch.cuda.synchronize()
    kt, ktri, kb = kt[idx], ktri[idx], kb[idx]
    agree, ties, max_ulp, same = hits_agree(scene, sub[0], sub[1], kt, ktri,
                                            pt, ptri)
    t_err = float((kt[same] - pt[same]).abs().max()) if same.any() else 0.0
    b_err = float((kb - pb).abs().max())
    shadow_agree = float((kb == pb).float().mean())
    ok = agree == 1.0 and max_ulp <= 2 and shadow_agree == 1.0
    rows.append(f"| {name} | {len(idx)} of {R} | {agree:.6f} ({ties} ties) "
                f"| {max_ulp} | {shadow_agree:.6f} | "
                f"{float((ktri >= 0).float().mean()):.3f} / "
                f"{float(kb.float().mean()):.3f} | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, t_err, b_err


def compare_bvh2(name, scene, closest, shadow, rows, stats=None):
    """K2 (both modes) and K3 against their twins on one wave.

    ``closest``: (ro, rd, active) for K2 closest-hit; ``shadow``: (ro, rd,
    tmax, active) for K2 any-hit and K3. Compared on SUBSET strided rays:
    tri agree 1.0 except t-ties, t within 2 ulp, u and v equal where the
    triangle is the same, blocked bits equal. ``stats``: receives the
    twins' work counts, by mode. Returns (ok, errors by mode).
    """
    import torch

    from loupiote_tpu_torch.ops import bvh2

    ro, rd, active = closest
    R = ro.shape[0]
    idx = strided(R, ro.device)
    tfar = torch.full((R,), 1e30, device=ro.device)
    tables = (scene.node_rows, scene.leaf_rows)
    trace = (scene.num_nodes, scene.stack_depth)
    occ = (scene.end_index, scene.num_nodes)
    stats = {} if stats is None else stats
    for k in ("closest", "anyhit", "occluded"):
        stats.setdefault(k, {})
    k_out = bvh2.bvh2_trace(*tables, ro, rd, tfar, active, False, *trace)
    k_any = bvh2.bvh2_trace(*tables, *shadow, True, *trace)[3] >= 0
    k_occ = bvh2.bvh2_occluded(*tables, *shadow, *occ) > 0
    sub = [x[idx].contiguous() for x in (ro, rd, tfar, active)]
    ssub = [x[idx].contiguous() for x in shadow]
    p_out = bvh2.bvh2_trace_plain(*tables, *sub, False, *trace,
                                  stats=stats["closest"])
    p_any = bvh2.bvh2_trace_plain(*tables, *ssub, True, *trace,
                                  stats=stats["anyhit"])[3] >= 0
    p_occ = bvh2.bvh2_occluded_plain(*tables, *ssub, *occ,
                                     stats=stats["occluded"]) > 0
    torch.cuda.synchronize()
    kt, ku, kv, ktri = (x[idx] for x in k_out)
    pt, pu, pv, ptri = p_out
    agree, ties, max_ulp, same = hits_agree(scene, sub[0], sub[1], kt, ktri,
                                            pt, ptri)
    uv_same = bool((ku[same] == pu[same]).all() & (kv[same] == pv[same]).all())
    any_agree = float((k_any[idx] == p_any).float().mean())
    occ_agree = float((k_occ[idx] == p_occ).float().mean())
    cross = float((k_any == k_occ).float().mean())
    ok = (agree == 1.0 and max_ulp <= 2 and uv_same and any_agree == 1.0
          and occ_agree == 1.0)
    rows.append(f"| {name} | {len(idx)} of {R} | {agree:.6f} ({ties} ties) "
                f"| {max_ulp} | {uv_same} | {any_agree:.6f} | "
                f"{occ_agree:.6f} | {cross:.6f} | "
                f"{float((ktri >= 0).float().mean()):.3f} / "
                f"{float(k_occ.float().mean()):.3f} | "
                f"{'PASS' if ok else 'FAIL'} |")
    errs = {
        "closest": (float((kt[same] - pt[same]).abs().max())
                    if same.any() else 0.0),
        "anyhit": float((k_any[idx].int() - p_any.int()).abs().max()),
        "occluded": float((k_occ[idx].int() - p_occ.int()).abs().max()),
    }
    return ok, errs


def random_scene(device):
    from loupiote_tpu_torch import build_scene_buffers
    from loupiote_tpu_torch.scene.types import Instance, Mesh, Scene

    rng = np.random.default_rng(7)
    n = 4000
    v0 = ((rng.random((n, 3)) - 0.5) * 20).astype(np.float32)
    v1 = v0 + (rng.random((n, 3)) - 0.5).astype(np.float32)
    v2 = v0 + (rng.random((n, 3)) - 0.5).astype(np.float32)
    scene = Scene.default()
    pos = np.empty((n * 3, 3), np.float32)
    pos[0::3], pos[1::3], pos[2::3] = v0, v1, v2
    scene.meshes.append(Mesh(pos, None, None,
                             np.arange(n * 3, dtype=np.uint32)))
    scene.instances.append(Instance(0, np.eye(4, dtype=np.float32), 0))
    return build_scene_buffers(scene, device=device), rng


def waves(scene, cam, width, height, seed):
    """A primary wave of ``width`` x ``height`` pixels in tile order, its
    NEE shadow wave toward the light, and a cosine-diffuse wave from the
    primary hits (not sorted). Returns (primary, nee, diffuse) as
    ((ro, rd, active), (ro, rd, tmax, active), (ro, rd, active))."""
    import torch

    from loupiote_tpu_torch.ops.intersect import intersect_any
    from loupiote_tpu_torch.ops.raygen import generate_rays
    from loupiote_tpu_torch.ops.sampling import (cosine_sample_hemisphere,
                                                 orthonormal_basis, to_world)
    from loupiote_tpu_torch.ops.shade import sample_light
    from loupiote_tpu_torch.render.integrator import to_tile_order

    dev = cam.device
    N = width * height
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    jit = torch.rand(N, 2, generator=g, device=dev)
    pro, prd = generate_rays(cam, width, height, math.radians(45.0), jit)
    if width % 128 == 0 and height % 8 == 0:
        pro = to_tile_order(pro, width, height)
        prd = to_tile_order(prd, width, height)
    pro, prd = pro.contiguous(), prd.contiguous()
    on = torch.ones(N, dtype=torch.bool, device=dev)
    hit = intersect_any(scene, pro, prd)
    hitm = hit.tri >= 0
    gn = scene.tri_shade[hit.tri.clamp_min(0).long(), 17:20]
    gn = torch.where(((gn * prd).sum(1) > 0)[:, None], -gn, gn)
    pos = pro + hit.t[:, None] * prd + gn * 1e-3
    u = torch.rand(N, 3, generator=g, device=dev)
    swi, sdist, _, _ = sample_light(scene, pos, u[:, 0], u[:, 1], u[:, 2])
    nee = (pos.contiguous(), swi.contiguous(),
           (sdist * (1.0 - 1e-3)).contiguous(), hitm)
    t_, bt = orthonormal_basis(gn)
    u2 = torch.rand(N, 2, generator=g, device=dev)
    drd = to_world(gn, t_, bt, cosine_sample_hemisphere(u2[:, 0], u2[:, 1]))
    return (pro, prd, on), nee, (pos.contiguous(), drd.contiguous(), hitm)


def ops_of(stats, n_compared, n_rays, box_key="visits"):
    """Operations of a whole wave from the twin's work counts on the
    compared subset, scaled by rays."""
    ops = stats[box_key] * OPS_BOX + stats["tri_tests"] * OPS_TRI
    return ops * n_rays / max(n_compared, 1)


def main():
    t_all = time.perf_counter()
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch import _build
    from loupiote_tpu_torch.accel import native
    from loupiote_tpu_torch.denoise.asvgf import denoise
    from loupiote_tpu_torch.ops import bvh2, wide
    from loupiote_tpu_torch.ops.sort import ray_sort_key, sort_order
    from loupiote_tpu_torch.render import renderer as rmod
    from loupiote_tpu_torch.render.integrator import (draw_uniforms,
                                                      trace_paths)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible; "
          f"{smi}")
    phase("device", t0)

    # -- build: every kernel source and the BVH builder, in parallel ------
    t0 = time.perf_counter()
    kernels_src = ("wide_traverse", "bvh2_traverse")
    with ThreadPoolExecutor(len(kernels_src) + 1) as pool:
        futs = [pool.submit(_build.load, k) for k in kernels_src]
        t1 = time.perf_counter()
        fut_bvh = pool.submit(native._load)
        for f in futs + [fut_bvh]:
            f.result()
    for k in kernels_src:
        info = _build.build_info[k]
        print(f"nvcc {k}.cu: {info['seconds']:.2f} s\n{info['log']}")
    print(f"BVH builder: native C++ ({native.SOURCE}, g++ -O3, "
          f"{native.OPT_ROUNDS} insertion-optimizer rounds); all builds "
          f"done {time.perf_counter() - t1:.2f} s after start")
    phase("build", t0)

    # -- K1 against its plain twin ----------------------------------------
    t0 = time.perf_counter()
    rows = ["| wave | rays compared | tri agree (ties) | t max ulp | "
            "shadow agree | hit / blocked frac | verdict |",
            "|---|---|---|---|---|---|---|"]
    ok = True
    rscene, rng = random_scene(dev)
    R = 64 * 1024
    ro = torch.from_numpy(((rng.random((R, 3)) - 0.5) * 30)
                          .astype(np.float32)).to(dev)
    rd = torch.from_numpy((rng.random((R, 3)) - 0.5).astype(np.float32))
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(dev)
    on = torch.ones(R, dtype=torch.bool, device=dev)
    r_shadow = (ro, rd, torch.full((R,), 25.0, device=dev), on)
    ok &= compare_wide("random-4k / random rays (shadow: tmax 25)", rscene,
                       (ro, rd, on), r_shadow, rows)[0]
    phase("K1: random-4k", t0)

    t0 = time.perf_counter()
    scene_cpu = lt.build_arch_scene(260_000)
    t1 = time.perf_counter()
    arch = lt.build_scene_buffers(scene_cpu)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    trav_bytes = arch.trav_rows.numel() * 4
    print(f"arch-260k: {scene_cpu.stats()['triangles']} triangles, scene "
          f"{t1 - t0:.2f} s, buffers (native BVH + tables + upload) "
          f"{build_s:.2f} s; BVH2 nodes {arch.num_nodes}, wide rows "
          f"{arch.wide_end}, wide_stack {arch.wide_stack}, trav_rows "
          f"{trav_bytes} bytes ({trav_bytes / 1e6:.2f} MB; L2 50 MB)")
    phase("scene build", t0)

    t0 = time.perf_counter()
    cam = torch.from_numpy(lt.arch_camera()).to(dev)
    N = WIDTH * HEIGHT
    prim, nee, diff = waves(arch, cam, WIDTH, HEIGHT, seed=0)
    k1_stats = {}
    ok_p, t_err, b_err = compare_wide(
        "arch-260k / primary 1080p (shadow: NEE to the light)", arch, prim,
        nee, rows, stats=k1_stats)
    ok &= ok_p
    dro, drd, dact = diff
    order = sort_order(ray_sort_key(dro, drd, dact, arch.node_min[0],
                                    arch.node_max[0]))
    dro, drd, dact = (dro[order].contiguous(), drd[order].contiguous(),
                      dact[order].contiguous())
    ok &= compare_wide("arch-260k / diffuse 1080p, sorted (shadow: tmax 25)",
                       arch, (dro, drd, dact),
                       (dro, drd, torch.full((N,), 25.0, device=dev), dact),
                       rows)[0]
    print("\n".join(rows), flush=True)
    phase("K1: arch-260k waves", t0)

    # K1 time at the headline path's shapes: the 1080p primary wave
    # (closest-hit) and its NEE shadow wave (any-hit).
    t0 = time.perf_counter()
    tfar = torch.full((N,), 1e30, device=dev)
    k1_timing = {}
    k1_args = {"closest": (prim[0], prim[1], tfar, prim[2]), "anyhit": nee}
    for mode, wave in k1_args.items():
        args = (arch.trav_rows, *wave, mode == "anyhit", arch.wide_end,
                arch.wide_stack)
        k1_timing[mode] = (cuda_ms(lambda: wide.wide_trace(*args), 10),
                           cuda_ms(lambda: wide.wide_trace_plain(*args), 1))
        print(f"K1 {mode} on the 1080p primary/NEE wave ({N} rays): kernel "
              f"{k1_timing[mode][0]:.3f} ms, plain torch "
              f"{k1_timing[mode][1]:.3f} ms", flush=True)
    n_cmp = len(strided(N, dev))
    k1_bound = {m: bound(N, 8, trav_bytes,
                         ops_of(k1_stats[m], n_cmp, N, box_key="box_tests"))
                for m in ("closest", "anyhit")}
    for m, (b_ms, b_by) in k1_bound.items():
        print(f"K1 {m} bound on the 1080p wave: {b_ms:.4f} ms ({b_by}; "
              f"twin work on {n_cmp} rays: {k1_stats[m]})")
    phase("K1 timing", t0)
    if not ok:
        raise SystemExit("chip_smoke: K1 disagrees with its plain version")

    # -- K2 and K3 against their plain twins --------------------------------
    t0 = time.perf_counter()
    rows = ["| wave | rays compared | K2 tri agree (ties) | t max ulp | "
            "u,v equal | K2 any-hit agree | K3 agree | K2 any-hit = K3 | "
            "hit / blocked frac | verdict |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    ok = compare_bvh2("random-4k / random rays (shadow: tmax 25)", rscene,
                      (ro, rd, on), r_shadow, rows)[0]
    scene40 = lt.build_arch_scene(40_000)
    t1 = time.perf_counter()
    arch40 = lt.build_scene_buffers(scene40)
    torch.cuda.synchronize()
    tables40 = (arch40.node_rows.numel() + arch40.leaf_rows.numel()) * 4
    print(f"arch-40k: {scene40.stats()['triangles']} triangles; buffers "
          f"{time.perf_counter() - t1:.2f} s; BVH2 nodes {arch40.num_nodes} "
          f"(< {8192}: K2/K3), leaves {arch40.leaf_rows.shape[0]}, "
          f"stack_depth {arch40.stack_depth}; node_rows + leaf_rows "
          f"{tables40} bytes; trav_rows {arch40.trav_rows.numel() * 4} bytes")
    w40, h40 = WIDTH // 2, HEIGHT // 2
    N40 = w40 * h40
    prim40, nee40, diff40 = waves(arch40, cam, w40, h40, seed=1)
    k23_stats = {}
    ok_p, k23_err = compare_bvh2(
        f"arch-40k / primary {w40}x{h40} (shadow: NEE to the light)", arch40,
        prim40, nee40, rows, stats=k23_stats)
    ok &= ok_p
    dro, drd, dact = diff40
    ok &= compare_bvh2(f"arch-40k / diffuse {w40}x{h40}, unsorted "
                       f"(shadow: tmax 25)", arch40, diff40,
                       (dro, drd, torch.full((N40,), 25.0, device=dev),
                        dact), rows)[0]
    print("\n".join(rows), flush=True)
    phase("K2/K3: three waves", t0)
    if not ok:
        raise SystemExit("chip_smoke: K2 or K3 disagrees with its plain "
                         "version")

    # Times on the interactive path's waves: K2 closest-hit on the primary
    # wave, K2 any-hit and K3 on its NEE wave; K1 on the same waves.
    t0 = time.perf_counter()
    tfar40 = torch.full((N40,), 1e30, device=dev)
    p40 = (prim40[0], prim40[1], tfar40, prim40[2])
    tb40 = (arch40.node_rows, arch40.leaf_rows)
    tr40 = (arch40.num_nodes, arch40.stack_depth)
    oc40 = (arch40.end_index, arch40.num_nodes)
    calls = {
        "K2 closest": (lambda: bvh2.bvh2_trace(*tb40, *p40, False, *tr40),
                       lambda: bvh2.bvh2_trace_plain(*tb40, *p40, False,
                                                     *tr40)),
        "K2 any-hit": (lambda: bvh2.bvh2_trace(*tb40, *nee40, True, *tr40),
                       lambda: bvh2.bvh2_trace_plain(*tb40, *nee40, True,
                                                     *tr40)),
        "K3": (lambda: bvh2.bvh2_occluded(*tb40, *nee40, *oc40),
               lambda: bvh2.bvh2_occluded_plain(*tb40, *nee40, *oc40)),
    }
    k23_timing = {}
    for name, (kfn, pfn) in calls.items():
        k23_timing[name] = (cuda_ms(kfn, 20), cuda_ms(pfn, 1))
    wide40 = (arch40.trav_rows,)
    ws40 = (arch40.wide_end, arch40.wide_stack)
    k1_40 = {
        "closest": cuda_ms(lambda: wide.wide_trace(*wide40, *p40, False,
                                                   *ws40), 20),
        "anyhit": cuda_ms(lambda: wide.wide_trace(*wide40, *nee40, True,
                                                  *ws40), 20),
    }
    n40 = len(strided(N40, dev))
    k23_bound = {
        "K2 closest": bound(N40, 16, tables40,
                            ops_of(k23_stats["closest"], n40, N40)),
        "K2 any-hit": bound(N40, 16, tables40,
                            ops_of(k23_stats["anyhit"], n40, N40)),
        "K3": bound(N40, 4, tables40,
                    ops_of(k23_stats["occluded"], n40, N40)),
    }
    for name, (k_ms, p_ms) in k23_timing.items():
        b_ms, b_by = k23_bound[name]
        print(f"{name} on the arch-40k {w40}x{h40} "
              f"{'primary' if name == 'K2 closest' else 'NEE'} wave ({N40} "
              f"rays): kernel {k_ms:.4f} ms, plain torch {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    print(f"dispatch comparison on the same arch-40k waves: K1 closest-hit "
          f"{k1_40['closest']:.4f} ms vs K2 {k23_timing['K2 closest'][0]:.4f}"
          f" ms; K1 any-hit {k1_40['anyhit']:.4f} ms vs K3 "
          f"{k23_timing['K3'][0]:.4f} ms ({smi})", flush=True)
    phase("K2/K3 timing", t0)

    # -- The headline path ---------------------------------------------------
    t0 = time.perf_counter()
    renderer = lt.Renderer((WIDTH, HEIGHT),
                           lt.RenderConfig(downsample_factor=1.0,
                                           denoise=False))
    renderer.set_resources(arch)
    renderer.accumulate = True
    view = lt.arch_camera()
    wide.reset_counters()
    bvh2.reset_counters()
    renderer.raytrace(view)  # warm-up frame; accum == its sample
    first = renderer.accum.clone()
    frame_ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        renderer.raytrace(view)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    img = renderer.blit()
    k1_launches = {"closest": wide.launches_closest,
                   "anyhit": wide.launches_anyhit}
    capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
    print(f"headline path: 6 frames; K1 launches {k1_launches}; K2/K3 "
          f"launches {bvh2.launches_closest} / {bvh2.launches_occluded}; "
          f"rays stopped by the step bound {capped}")
    if k1_launches["closest"] == 0 or k1_launches["anyhit"] == 0:
        raise SystemExit("chip_smoke: the headline path did not launch K1")
    if capped:
        raise SystemExit("chip_smoke: rays reached the step bound")
    if not (torch.isfinite(renderer.accum).all() and img.shape ==
            (HEIGHT, WIDTH, 3) and img.dtype == np.uint8):
        raise SystemExit("chip_smoke: non-finite or misshapen image")
    nonzero = float((first.reshape(-1, 3).sum(1) > 0).float().mean())
    ms = float(np.mean(frame_ms))
    rays = WIDTH * HEIGHT * BOUNCES * 2
    print(f"frame ms (CUDA events): mean {ms:.3f}, min {min(frame_ms):.3f}, "
          f"all {[round(x, 3) for x in frame_ms]}; "
          f"Mrays/s {rays / ms / 1e3:.3f} "
          f"(pixels x bounces x 2); nonzero_pixel_frac (1 spp) {nonzero:.4f}; "
          f"image mean {float(renderer.accum.mean()):.5f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if nonzero < 0.5:
        raise SystemExit("chip_smoke: the frame is mostly black")
    phase("headline path (warm-up + 5 frames + blit)", t0)

    # Small frame: the card's path against the plain CPU path, same
    # uniforms, sort off (a 1-ulp key change would reassign uniforms).
    t0 = time.perf_counter()
    w, h = 128, 64
    gu = torch.Generator(device="cpu")
    gu.manual_seed(3)
    uni = draw_uniforms(w * h, BOUNCES, gu, "cpu")
    ref = trace_paths(arch.to("cpu"), cam.cpu(), w, h, bounces=BOUNCES,
                      sort_rays=False, uniforms=uni)[0]
    out = trace_paths(arch, cam, w, h, bounces=BOUNCES, sort_rays=False,
                      uniforms=uni.to(dev))[0].cpu()
    close = float(torch.isclose(out, ref, rtol=1e-4, atol=1e-5).all(1)
                  .float().mean())
    rel = abs(float(out.mean()) / max(float(ref.mean()), 1e-12) - 1.0)
    print(f"small frame {w}x{h} card vs CPU plain path: pixels close "
          f"{close:.5f}, mean rel diff {rel:.2e}")
    if close < 0.995 or rel > 1e-3:
        raise SystemExit("chip_smoke: the card's frame disagrees with the "
                         "CPU path")
    phase("headline frame vs CPU", t0)

    # -- The interactive path: the app's default frame -----------------------
    t0 = time.perf_counter()
    del renderer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inter = lt.Renderer((WIDTH, HEIGHT), lt.RenderConfig())
    inter.set_resources(arch40)
    inter.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    view = lt.arch_camera()
    wide.reset_counters()
    bvh2.reset_counters()
    inter.raytrace(view)  # warm-up
    frame_ms = []
    for _ in range(10):
        view[0, 3] += 1e-3  # the camera moves every frame
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inter.raytrace(view)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    view[0, 3] += 1e-3
    t1 = time.perf_counter()
    inter.raytrace(view)
    img = inter.blit()
    host_ms = (time.perf_counter() - t1) * 1e3
    launches = {"K1 closest": wide.launches_closest,
                "K1 any-hit": wide.launches_anyhit,
                "K2 closest": bvh2.launches_closest,
                "K2 any-hit": bvh2.launches_anyhit,
                "K3": bvh2.launches_occluded}
    capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    iw, ih = inter.get_size()
    print(f"interactive path: {iw}x{ih} internal in a {WIDTH}x{HEIGHT} "
          f"window, 12 frames; launches {launches}; rays stopped by the "
          f"step bound {capped}; peak memory {peak:.2f} GiB")
    if launches["K2 closest"] == 0 or launches["K3"] == 0:
        raise SystemExit("chip_smoke: the interactive path did not launch "
                         "K2 and K3")
    if launches["K1 closest"] or launches["K1 any-hit"]:
        raise SystemExit("chip_smoke: the interactive path launched K1")
    if capped:
        raise SystemExit("chip_smoke: rays reached the step bound")
    if not (torch.isfinite(inter.state.denoised).all()
            and img.shape == (HEIGHT, WIDTH, 3) and img.dtype == np.uint8):
        raise SystemExit("chip_smoke: non-finite or misshapen denoised frame")
    ims = float(np.mean(frame_ms))
    print(f"interactive frame ms (CUDA events): mean {ims:.3f}, min "
          f"{min(frame_ms):.3f}, all {[round(x, 3) for x in frame_ms]}; "
          f"fps {1e3 / ims:.2f}; host-clock frame with blit {host_ms:.3f} "
          f"ms", flush=True)

    # One more frame by hand, to time A-SVGF alone on its own inputs and
    # read the 1-spp sample.
    st = inter.state
    view[0, 3] += 1e-3
    sample, gb = trace_paths(arch40, torch.from_numpy(view).to(dev), iw, ih,
                             inter.generator, bounces=3,
                             vfov=math.radians(45.0))
    motion = rmod.motion_vectors(st.prev_world_to_screen, gb, iw, ih)
    d_in = (sample.reshape(ih, iw, 3), gb.albedo.reshape(ih, iw, 3), motion,
            gb.normal.reshape(ih, iw, 3), gb.depth.reshape(ih, iw),
            gb.mesh_id.reshape(ih, iw), st.gb_normal, st.gb_depth,
            st.gb_mesh, st.asvgf_illum, st.asvgf_moments, st.asvgf_history)
    asvgf_ms = cuda_ms(lambda: denoise(*d_in, iterations=4), 5)
    nonzero = float((sample.sum(1) > 0).float().mean())
    print(f"A-SVGF alone (4 a-trous iterations, {iw}x{ih}): {asvgf_ms:.3f} "
          f"ms = {asvgf_ms / ims:.1%} of the frame; 1-spp sample "
          f"nonzero_pixel_frac {nonzero:.4f}; denoised mean "
          f"{float(inter.state.denoised.mean()):.5f}")
    if nonzero < 0.5:
        raise SystemExit("chip_smoke: the 1-spp sample is mostly black")
    for mode in lt.BlitMode:
        inter.set_blit_mode(mode)
        inter.raytrace(view)
        out = inter.blit()
        if out.shape != (HEIGHT, WIDTH, 3) or out.dtype != np.uint8:
            raise SystemExit(f"chip_smoke: blit {mode} gave {out.shape} "
                             f"{out.dtype}")
    print(f"blit modes {[m.value for m in lt.BlitMode]}: each "
          f"({HEIGHT}, {WIDTH}, 3) uint8")
    phase("interactive path (warm-up + 10 frames + blit + modes)", t0)

    # Two small denoised frames: the card against the CPU path, the same
    # uniforms; the second frame reprojects the first. The standard of the
    # headline's small-frame check.
    t0 = time.perf_counter()
    gu.manual_seed(5)
    unis = [draw_uniforms(w * h, BOUNCES, gu, "cpu") for _ in range(2)]
    arch40_cpu = arch40.to("cpu")
    s_cpu = rmod.init_state(w, h, "cpu")
    s_dev = rmod.init_state(w, h, dev)
    kw = dict(width=w, height=h, bounces=BOUNCES, nee=True,
              vfov=math.radians(45.0), mode="denoised", atrous_iterations=4)
    for i in range(2):
        v = lt.arch_camera()
        v[0, 3] += 1e-3 * i
        w2s = torch.from_numpy(lt.Camera(v, (w, h), math.radians(45.0))
                               .world_to_screen())
        v = torch.from_numpy(v)
        s_cpu = rmod.render_frame(arch40_cpu, s_cpu, v, w2s, False,
                                  uniforms=unis[i], **kw)
        s_dev = rmod.render_frame(arch40, s_dev, v.to(dev), w2s.to(dev),
                                  False, uniforms=unis[i].to(dev), **kw)
    a, b = s_dev.denoised.cpu().reshape(-1, 3), s_cpu.denoised.reshape(-1, 3)
    close = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(1)
                  .float().mean())
    rel = abs(float(a.mean()) / max(float(b.mean()), 1e-12) - 1.0)
    print(f"small denoised frames {w}x{h} (2 frames) card vs CPU plain "
          f"path: pixels close {close:.5f}, mean rel diff {rel:.2e}")
    if close < 0.995 or rel > 1e-3:
        raise SystemExit("chip_smoke: the card's denoised frame disagrees "
                         "with the CPU path")
    phase("denoised frames vs CPU", t0)

    kernels = []
    for mode, err in (("closest", t_err), ("anyhit", b_err)):
        b_ms, b_by = k1_bound[mode]
        kernels.append({
            "name": f"wide_traverse ({mode})", "route": "cuda",
            "source": "loupiote_tpu_torch/csrc/wide_traverse.cu",
            "replaces": "loupiote_tpu/ops/pallas_wide.py:160",
            "launches": k1_launches[mode], "max_abs_err": err,
            "ms": k1_timing[mode][0], "plain_ms": k1_timing[mode][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    any_ms, any_plain = k23_timing["K2 any-hit"]
    for name, fn, line, key, err_key in (
            ("bvh2_trace", "K2 closest", 67, "K2 closest", "closest"),
            ("bvh2_occluded", "K3", 260, "K3", "occluded")):
        b_ms, b_by = k23_bound[key]
        entry = {
            "name": name, "route": "cuda",
            "source": "loupiote_tpu_torch/csrc/bvh2_traverse.cu",
            "replaces": f"loupiote_tpu/ops/pallas_intersect.py:{line}",
            "launches": launches[key], "max_abs_err": k23_err[err_key],
            "ms": k23_timing[key][0], "plain_ms": k23_timing[key][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if name == "bvh2_trace":
            # K2's any-hit mode: checked and timed here, not on the path.
            entry["modes"] = {"anyhit": {
                "launches": launches["K2 any-hit"],
                "max_abs_err": k23_err["anyhit"], "ms": any_ms,
                "plain_ms": any_plain,
                "bound_ms": k23_bound["K2 any-hit"][0],
                "bound_by": k23_bound["K2 any-hit"][1]}}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
