#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (loupiote_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed:
  1. device   - require CUDA; print the card and its power limit;
  2. build    - compile the traversal kernel (nvcc) and the BVH builder (g++);
  3. kernels  - kernel K1 (csrc/wide_traverse.cu) against its plain torch
                twin on the card, closest-hit and any-hit, on a random
                4k-triangle scene, the arch-260k primary wave at 1080p and a
                sorted diffuse wave; any disagreement fails the run;
  4. frame    - the main path: arch-260k at 1920x1080, 3 bounces, NEE,
                1 spp, through Renderer.set_resources -> raytrace -> blit,
                with K1's launch counts read around it, and a small frame
                held against the same frame traced by the plain CPU path.
Prints a JSON line of kernel results, then the card's nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Any failure raises, so the
run exits non-zero without that last line.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, BOUNCES = 1920, 1080, 3
SUBSET = 65_536  # rays the plain traversal replays of each full wave


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


def compare_wave(name, scene, closest, shadow, rows):
    """K1 against wide_trace_plain on one wave in both modes.

    ``closest``: (ro, rd, active); ``shadow``: (ro, rd, tmax, active). The
    kernel runs on the whole wave; the plain version on SUBSET rays of it
    (evenly strided), where the two are compared. Ties: rays whose two
    triangles lie within 2 ulp of each other along the ray. Returns
    (ok, max |t| error, max |blocked| error) over the compared rays.
    """
    import torch

    from loupiote_tpu_torch.ops import wide

    ro, rd, active = closest
    R = ro.shape[0]
    idx = torch.arange(0, R, max(R // SUBSET, 1), device=ro.device)[:SUBSET]
    tfar = torch.full((R,), 1e30, device=ro.device)
    table = (scene.trav_rows,)
    sizes = (scene.wide_end, scene.wide_stack)
    kt, ktri = wide.wide_trace(*table, ro, rd, tfar, active, False, *sizes)
    kb = wide.wide_trace(*table, *shadow, True, *sizes)[1]
    pt, ptri = wide.wide_trace_plain(*table, *(x[idx].contiguous() for x in
                                               (ro, rd, tfar, active)),
                                     False, *sizes)
    pb = wide.wide_trace_plain(*table, *(x[idx].contiguous()
                                         for x in shadow), True, *sizes)[1]
    torch.cuda.synchronize()
    kt, ktri, kb = kt[idx], ktri[idx], kb[idx]
    same = ktri == ptri
    tie = ~same & (ulp_diff(tri_t(scene, ro[idx], rd[idx], ktri),
                            tri_t(scene, ro[idx], rd[idx], ptri)) <= 2)
    tri_agree = float((same | tie).float().mean())
    max_ulp = int(ulp_diff(kt[same], pt[same]).max()) if same.any() else 0
    t_err = float((kt[same] - pt[same]).abs().max()) if same.any() else 0.0
    b_err = float((kb - pb).abs().max())
    shadow_agree = float((kb == pb).float().mean())
    ok = tri_agree == 1.0 and max_ulp <= 2 and shadow_agree == 1.0
    rows.append(f"| {name} | {len(idx)} of {R} | {tri_agree:.6f} "
                f"({int(tie.sum())} ties) | {max_ulp} | {shadow_agree:.6f} "
                f"| {float((ktri >= 0).float().mean()):.3f} / "
                f"{float(kb.float().mean()):.3f} | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, t_err, b_err


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
    from loupiote_tpu_torch.ops import wide
    from loupiote_tpu_torch.ops.raygen import generate_rays
    from loupiote_tpu_torch.ops.sampling import (cosine_sample_hemisphere,
                                                 orthonormal_basis, to_world)
    from loupiote_tpu_torch.ops.shade import sample_light
    from loupiote_tpu_torch.ops.sort import ray_sort_key, sort_order
    from loupiote_tpu_torch.render.integrator import (draw_uniforms,
                                                      to_tile_order,
                                                      trace_paths)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    phase("device", t0)

    t0 = time.perf_counter()
    _build.load("wide_traverse")
    info = _build.build_info["wide_traverse"]
    print(f"nvcc wide_traverse.cu: {info['seconds']:.2f} s\n{info['log']}")
    t1 = time.perf_counter()
    native._load()
    print(f"BVH builder: native C++ ({native.SOURCE}, g++ -O3, "
          f"{native.OPT_ROUNDS} insertion-optimizer rounds), compiled in "
          f"{time.perf_counter() - t1:.2f} s")
    phase("build", t0)

    # -- K1 against its plain twin --------------------------------------
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
    ok &= compare_wave("random-4k / random rays (shadow: tmax 25)", rscene,
                       (ro, rd, on),
                       (ro, rd, torch.full((R,), 25.0, device=dev), on),
                       rows)[0]
    phase("kernels: random-4k", t0)

    t0 = time.perf_counter()
    scene_cpu = lt.build_arch_scene(260_000)
    t1 = time.perf_counter()
    arch = lt.build_scene_buffers(scene_cpu, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    trav_bytes = arch.trav_rows.numel() * 4
    print(f"arch-260k: {scene_cpu.stats()['triangles']} triangles, scene "
          f"{t1 - t0:.2f} s, buffers (native BVH + wide collapse + upload) "
          f"{build_s:.2f} s; BVH2 nodes {arch.num_nodes}, wide rows "
          f"{arch.wide_end}, wide_stack {arch.wide_stack}, trav_rows "
          f"{trav_bytes} bytes ({trav_bytes / 1e6:.2f} MB; L2 50 MB)")
    phase("scene build", t0)

    t0 = time.perf_counter()
    cam = torch.from_numpy(lt.arch_camera()).to(dev)
    N = WIDTH * HEIGHT
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    jit = torch.rand(N, 2, generator=g, device=dev)
    pro, prd = generate_rays(cam, WIDTH, HEIGHT, math.radians(45.0), jit)
    pro = to_tile_order(pro, WIDTH, HEIGHT).contiguous()
    prd = to_tile_order(prd, WIDTH, HEIGHT).contiguous()
    on = torch.ones(N, dtype=torch.bool, device=dev)
    hit = wide.intersect_wide(arch, pro, prd)
    hitm = hit.tri >= 0
    # Shadow wave of the primary hits toward the light (NEE shape).
    gn = arch.tri_shade[hit.tri.clamp_min(0).long(), 17:20]
    gn = torch.where(((gn * prd).sum(1) > 0)[:, None], -gn, gn)
    pos = pro + hit.t[:, None] * prd + gn * 1e-3
    u = torch.rand(N, 3, generator=g, device=dev)
    swi, sdist, _, _ = sample_light(arch, pos, u[:, 0], u[:, 1], u[:, 2])
    nee = (pos.contiguous(), swi.contiguous(),
           (sdist * (1.0 - 1e-3)).contiguous(), hitm)
    ok_p, t_err, b_err = compare_wave(
        "arch-260k / primary 1080p (shadow: NEE to the light)", arch,
        (pro, prd, on), nee, rows)
    ok &= ok_p
    # Sorted diffuse wave: cosine samples around the geometric normal.
    t_, bt = orthonormal_basis(gn)
    u2 = torch.rand(N, 2, generator=g, device=dev)
    drd = to_world(gn, t_, bt, cosine_sample_hemisphere(u2[:, 0], u2[:, 1]))
    order = sort_order(ray_sort_key(pos, drd, hitm, arch.node_min[0],
                                    arch.node_max[0]))
    dro, drd, dact = (pos[order].contiguous(), drd[order].contiguous(),
                      hitm[order].contiguous())
    ok &= compare_wave("arch-260k / diffuse 1080p, sorted (shadow: tmax 25)",
                       arch, (dro, drd, dact),
                       (dro, drd, torch.full((N,), 25.0, device=dev), dact),
                       rows)[0]
    print("\n".join(rows), flush=True)
    phase("kernels: arch-260k waves", t0)

    # Kernel vs plain time at the main path's shapes: the 1080p primary
    # wave (closest-hit) and its NEE shadow wave (any-hit).
    t0 = time.perf_counter()
    tfar = torch.full((N,), 1e30, device=dev)
    timing = {}
    for mode, wave in (("closest", (pro, prd, tfar, on)), ("anyhit", nee)):
        args = (arch.trav_rows, *wave, mode == "anyhit", arch.wide_end,
                arch.wide_stack)
        timing[mode] = (cuda_ms(lambda: wide.wide_trace(*args), 10),
                        cuda_ms(lambda: wide.wide_trace_plain(*args), 1))
        print(f"K1 {mode} on the 1080p primary/NEE wave ({N} rays): kernel "
              f"{timing[mode][0]:.3f} ms, plain torch {timing[mode][1]:.3f} "
              f"ms", flush=True)
    phase("kernel timing", t0)
    if not ok:
        raise SystemExit("chip_smoke: K1 disagrees with its plain version")

    # -- The main path ---------------------------------------------------
    t0 = time.perf_counter()
    renderer = lt.Renderer((WIDTH, HEIGHT),
                           lt.RenderConfig(downsample_factor=1.0,
                                           denoise=False))
    renderer.set_resources(arch)
    renderer.accumulate = True
    view = lt.arch_camera()
    wide.reset_counters()
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
    launches = {"closest": wide.launches_closest,
                "anyhit": wide.launches_anyhit}
    capped = wide.capped_rays(dev)
    print(f"main path: 6 frames; K1 launches {launches}; rays stopped by the "
          f"step bound {capped}")
    if launches["closest"] == 0 or launches["anyhit"] == 0:
        raise SystemExit("chip_smoke: the main path did not launch K1")
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
    phase("main path (warm-up + 5 frames + blit)", t0)

    # Small frame: the card's path against the plain CPU path, same
    # uniforms, sort off (a 1-ulp key change would reassign uniforms).
    t0 = time.perf_counter()
    w, h = 128, 64
    gu = torch.Generator(device="cpu")
    gu.manual_seed(3)
    uni = draw_uniforms(w * h, BOUNCES, gu, "cpu")
    ref = trace_paths(arch.to("cpu"), cam.cpu(), w, h, bounces=BOUNCES,
                      sort_rays=False, uniforms=uni)
    out = trace_paths(arch, cam, w, h, bounces=BOUNCES, sort_rays=False,
                      uniforms=uni.to(dev)).cpu()
    close = float(torch.isclose(out, ref, rtol=1e-4, atol=1e-5).all(1)
                  .float().mean())
    rel = abs(float(out.mean()) / max(float(ref.mean()), 1e-12) - 1.0)
    print(f"small frame {w}x{h} card vs CPU plain path: pixels close "
          f"{close:.5f}, mean rel diff {rel:.2e}")
    if close < 0.995 or rel > 1e-3:
        raise SystemExit("chip_smoke: the card's frame disagrees with the "
                         "CPU path")
    phase("frame vs CPU", t0)

    kernels = []
    for mode, err in (("closest", t_err), ("anyhit", b_err)):
        kernels.append({
            "name": f"wide_traverse ({mode})", "route": "cuda",
            "source": "loupiote_tpu_torch/csrc/wide_traverse.cu",
            "replaces": "loupiote_tpu/ops/pallas_wide.py:160",
            "launches": launches[mode], "max_abs_err": err,
            "ms": timing[mode][0], "plain_ms": timing[mode][1]})
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
