#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (loupiote_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed:
  1. device    - require CUDA; print the card and its power limit;
  2. build     - compile the kernels (nvcc, one process per source, in
                 parallel) and the BVH builder (g++);
  3. K1        - kernel K1 (csrc/wide_traverse.cu) against its plain torch
                 twin on the card, closest-hit and any-hit, on every ray
                 of each wave, exact (tri with ties, t bits, blocked
                 bits): a random 4k-triangle scene, the same scene with
                 every triangle twice (every hit a tie), the arch-260k
                 primary wave at 1080p with its NEE wave and a sorted
                 diffuse wave; 0 rays at the step bound; K1's time on
                 the 1080p waves;
  4. K2/K3     - kernels K2 and K3 (csrc/bvh2_traverse.cu) against their
                 twins, exact (K2: t, u, v, tri bits, ties included; K3:
                 blocked bits), on the random-4k scene, its tie wave
                 (every triangle twice), the arch-40k 960x540 primary
                 wave with its NEE wave and an arch-40k diffuse wave (its
                 shadow wave: tmax 25); K2 in both modes (closest-hit on
                 the random, primary and diffuse rays, any-hit on the
                 three shadow waves) and K3 on every ray of each wave,
                 three runs each, 0 rays at the step bound; K2's and K3's
                 ptxas report; K2, K3 and K1 times on the same arch-40k
                 waves (K2 and K1 closest-hit on the primary and the
                 diffuse wave, K3 and K1 any-hit on the NEE and the
                 diffuse shadow wave);
 4a. non-finite - K1 (both modes), K2 (both modes) and K3 against their
                 twins on every ray of the random-4k rays and of a
                 primary wave with +-inf / NaN origin and +-inf, -0 and
                 +-1e-30 direction components in one ray in eight
                 (nonfinite_rays): NaN-equal t, u, v, equal tri and
                 blocked bits, 0 rays at a step bound;
  5. headline  - arch-260k at 1920x1080, 3 bounces, NEE, 1 spp, pathtrace,
                 through Renderer.set_resources -> raytrace -> blit, with
                 the kernels' launch counts read around it, and a small
                 frame held against the same frame traced by the CPU path;
 5t. tiles     - make_mesh() of the host's cards printed; the headline
                 frame through Renderer(mesh=) on a 3x1 mesh of this card
                 (360-row slabs, tiled) and a 2x2 one (540-row slabs,
                 untiled, the spp mean), a warm-up and 5 frames each, K1's
                 launches a frame held to (3 + 4) x shards (21, 28), 0
                 rays at a step bound, the unsharded headline frame timed
                 again beside them; at 1080p each mesh's gathered
                 G-buffer bit-equal to the unsharded one under one
                 explicit jitter, and a 1x1 mesh bit-equal to trace_paths
                 with the same uniforms, radiance included; 128x48 frames
                 on 3x1 and 2x2 meshes and a 128x36 one on a 2x1 mesh
                 (untiled) against the same meshes of the CPU, the same
                 shard uniforms, sort off; the denoised frame on the 2x2
                 mesh (3 frames: finite, A-SVGF history above 1);
 5a. content   - 1920x1080 frames, each a warm-up and 5 timed, K1's
                 launches a frame held to 3 + 4 (3 + 7 with a probe):
                 (a) the textured arch-260k hall with 200 props through
                 Renderer, (b) the same under a 1024x2048 HDR sky with
                 blue noise and samples_per_frame=4, (c) trace_paths at
                 spp=4 on arch-260k beside the 1-spp call; K1 against
                 its twin, exact, on four waves recorded from one more
                 frame (b): the 8,294,400-slot primary wave, bounce 0's
                 env-NEE wave (tmax from scene_exit_t), bounce 1's
                 sorted continuation wave and the final gather; spp=2 in
                 one wave against the mean of its two 1-spp frames (blue
                 noise, sort off and on); a textured quad and a textured
                 arch-20k hall under a sky with blue noise, small, held
                 against the CPU path;
 5b. instanced - the textured arch-260k hall merged into one BLAS with 200
                 props of two meshes (bench.py's section_instanced)
                 through build_instanced_buffers and Renderer at
                 1920x1080, 3 bounces, NEE, 1 spp, a warm-up and 5
                 frames, beside the same scene flattened; K1's and K2's
                 launches a frame held to the plan of the scene's mesh
                 groups (K1 on the hall's BLAS once a traversal, K2 on
                 each prop group TLAS_C times, plus the drain's
                 iterations; no K3), the drain's iterations printed; the
                 frame's device kernels under torch.profiler; every K1
                 and K2 call of the primary and the first NEE traversal
                 against its twin on the same object-space rays (tri
                 bits equal, t within 2 ulp); an update_instance move
                 re-rendered with every BLAS tensor where it was; a
                 128x64 instanced frame against the CPU path;
  6. interactive - arch-40k in a 1920x1080 window with RenderConfig()
                 (960x540 internal, 3 bounces, NEE, A-SVGF) and
                 DENOISED_PATHTRACE, the camera moving every frame, with
                 the launch counts read around it; K2's and K3's device
                 time summed over one frame's launches (torch.profiler),
                 none of them stopping rays at the step bound; A-SVGF
                 timed alone;
                 every blit mode; a small denoised frame pair on the card
                 held against the CPU path;
  7. K4, E5    - arch-260k rebuilt with treelets=True; the slab sort K4
                 (csrc/slab_sort.cu): its launch plans, cluster shapes,
                 cudaOccupancyMaxActiveClusters and ptxas report, then K4
                 against its twin, three times each, with the CUDA
                 launches it made held to its plan, on the primary
                 wave's pair keys, random keys with three payload types,
                 uint32 keys with DEAD_KEYs, and one slab above a
                 cluster's span (global passes) of 2^20 keys with two,
                 three and four payloads and of 2^22 keys alone; timed
                 beside torch.sort + gather; E5 (csrc/regroup.cu) on the
                 primary and the sorted diffuse wave's pairs, three runs
                 each: the path's entry (regroup_blocks, K4's sorted
                 matrix to block_regroup's layout) against its plain
                 version and the grouped (key, ray) multiset, the
                 run-list entry (scatter_runs) against its twin; both
                 timed beside the parent's binning; block_regroup's
                 device kernels under torch.profiler (after K4 only E5's
                 three: no torch gather, scatter, searchsorted or
                 repeat_interleave);
  8. E6, E7    - the treelet walks (csrc/treelet_traverse.cu) against
                 their twins on strided rays of the primary and a diffuse
                 wave, E7 in both modes; E6's two epilogues (per ray;
                 compacting, against lane_top_plain + compact_pairs) on
                 every ray and pair slot of both waves, and at the primary
                 wave's full shapes E7's two epilogues (per pair, per ray)
                 in both modes, three kernel runs each bit-equal to the
                 plain version; their times on the primary wave;
  9. pipeline  - treelet_intersect against K1 on the full waves and
                 treelet_occluded on the NEE wave; one wave's time by
                 stage against K1's; phase 2's device kernels under
                 torch.profiler (E7 and the unpacking, no gather or
                 scatter_reduce);
 10. treelet   - the headline frame on the treelet tables through
                 Renderer, launch counts read around it (E6, K4, E5, E7 3
                 each a frame, E6's all compacting, E5's all the path's
                 entry and E7's all per ray; K4's and E5's CUDA launches
                 as their C entry points count them), and
                 a small frame held against the K1 path's;
 11. E1        - kernel_probe.main (the step-cost probe, csrc/kernel_probe.cu)
                 on the sorted arch-260k 1080p diffuse wave, its five
                 variants timed with launch counts read around it (K1's
                 too, which traces the primary wave on the way); each
                 variant's last path run and three more kernel runs held
                 against one run of probe_trace_plain on the card (t, u,
                 v, tri, steps bit-equal, dropped pushes equal, 0 but for
                 nofetch); full against K1's closest hits;
 12. E2        - lane_gather_bench.main (csrc/lane_gather.cu) at 64, 512
                 and 4,096 steps with launch counts; the kernel against
                 its twin, bit-equal with NaN counted equal: three runs at
                 128 x 1,024 lanes and 512 steps and one at 4,096, the
                 edge-case input (links with bits above 1,023, non-finite
                 origins and directions) at 128 x 1,024 lanes, and 1 and
                 3 x 1,024 lanes; ptxas's report and the launch's blocks;
 13. E3        - r3_probes.main all (csrc/r3_probes.cu): ten slopes between
                 30,000 and 230,000 steps with launch counts; each probe
                 against its twin, bit-equal, in three runs at 256 steps
                 and one at 1,024; the ptxas report of E1's and E3's
                 sources;
 14. E4        - device_sort_bench.main (K4's network over one 2^23-key
                 slab) against torch.sort + gather, with K4's launches
                 and CUDA launches counted; device_sort against slab_sort_plain at c_log 23
                 (keys and payload bit-equal) and against torch.sort, three
                 times.
  Non-finite inputs (after phases 8 and 13): E6 (both epilogues) and E7
                 (both epilogues and modes) on 4,096 rays of the primary
                 wave with nonfinite_rays' edge cases, E1's five variants on
                 256 packets of arch-4k's sorted diffuse wave with those
                 edge cases and E3's segmin on a tile with NaN and +-inf
                 entries, each against its twin three times: floats
                 NaN-equal, the rest bit-equal, 0 lanes at a step bound;
 15. app       - the textured arch-260k hall with 200 props written as a
                 glb with JPEG textures (encode_jpeg) and loaded by
                 Driver.load_gltf_path (meshes, instances, materials equal
                 to the in-memory scene's, texels to the JPEG round
                 trip's); `python -m loupiote_tpu_torch render`
                 of it at 1920x1080, 16 frames denoised (exit 0, the PNG's
                 nonzero share >= 0.9, ms a frame); Renderer.measure_passes
                 on the headline frame, pathtrace and denoised, by "trace"
                 with every label and > 0.3 of the device time under one;
                 the viewer server on loopback around a 1280x720 Driver (20
                 JPEG frames, a 'w' key moves the camera, /stats, the
                 gbuffer mode, a screenshot in the server's directory; the
                 loop's step / blit / encode ms); hot reload, clean and
                 with a source that does not compile (bit-equal frames, the
                 old libraries kept); the lightmap bake on arch-40k against
                 its CPU run.
Any disagreement or failure raises, so the run exits non-zero without its
last line. Prints a JSON line of kernel results (with the frames of 5t,
5a and 5b under "frames" and phase 15's numbers under "app"), then the
card's nvidia-smi line, then {"ok": true, "device": {...}} as the last
line.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

WIDTH, HEIGHT, BOUNCES = 1920, 1080, 3
SUBSET = 65_536  # rays the plain traversals replay of each full wave
# Edge-case rays a non-finite check gives E6 / E7, and packets of 128 rays
# it gives E1 (a few such rays walk far longer than a frame's rays, and a
# twin steps all its rays until the longest ends).
NONFINITE_RAYS = 4_096
NONFINITE_PACKETS = 256
# Bounds: H100 SXM peaks (HBM3 rate and dense FP32 rate), float32 outside the
# tensor cores, and the float operations of one box test (6 sub, 6 mul,
# 6 min/max of the slab pairs, 4 to combine, the clamp and 2 compares) and
# of one Moller-Trumbore test (46 arithmetic, 7 compares). A box test
# against a packet's near and far planes (E1 on an octant-coherent packet)
# needs none of the 6 min/max of the slab pairs.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
OPS_BOX, OPS_TRI = 25, 53
OPS_PLANE = OPS_BOX - 6
RAY_IN_BYTES = 12 + 12 + 4 + 1  # ro, rd, tmax, active


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def timed(fn, reps, warm=True):
    """(mean device milliseconds of fn() over reps calls after one warm-up
    unless ``warm`` is False, the last call's result)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cuda_ms(fn, reps, warm=True):
    return timed(fn, reps, warm)[0]


def device_kernels(fn, complete=None):
    """(name, ms) of each device kernel of one call of fn, in the order
    they started, from torch.profiler: fn runs twice under the profiler's
    schedule, a warm-up step that is traced and dropped, then the step
    that is read (on the card, a second profiler session in one process
    has missed the first kernels it should have recorded). ``complete``:
    a test of that list which a whole step passes (a kernel fn always
    launches); where given, a profile that fails it is taken again, up to
    three profiles, because the read step too has missed its first
    kernels on the card (E7 in phase 2, in two runs of four in one call;
    a K2 launch of the interactive frame in one run of four in another).
    Returns the last profile's list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    tries = 3
    for attempt in range(1, tries + 1):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.extend(p.events())) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        got = sorted((e for e in got if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        out = [(e.name, e.time_range.elapsed_us() / 1e3) for e in got]
        if complete is None or complete(out):
            break
        print(f"torch.profiler recorded {len(out)} kernels of the profiled "
              f"call, not every kernel it launches (profile {attempt} of "
              f"{tries})", flush=True)
    return out


def kernel_name(name):
    """The last ``*_kernel`` identifier in a profiler's kernel name."""
    found = re.findall(r"\w+_kernel", name)
    return found[-1] if found else name


def bound_of(nbytes, ops):
    """(ms, which): the larger of the bytes over the memory rate and the
    operations over the float32 rate."""
    b_ms = nbytes / PEAK_BYTES_S
    o_ms = ops / PEAK_FLOP_S
    return (max(b_ms, o_ms) * 1e3,
            "bytes" if b_ms >= o_ms else "operations")


def bound(n_rays, out_bytes, table_bytes, ops):
    """bound_of for a traversal: each ray's inputs and outputs once, the
    tables once."""
    return bound_of(n_rays * (RAY_IN_BYTES + out_bytes) + table_bytes, ops)


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


def compare_wide(name, scene, closest, shadow, rows, stats=None,
                 n_first=None):
    """K1 against wide_trace_plain on every ray of one wave, both modes.

    ``closest``: (ro, rd, active); ``shadow``: (ro, rd, tmax, active).
    Exact: tri equal on every ray (ties included: both follow one visit
    order), t bit-equal, blocked bits equal. ``stats``: receives the
    twin's work counts, by mode. ``n_first``: where every triangle t has
    a copy t + n_first, the share of hits the copy wins is printed.
    Returns (ok, max |t| error, max |blocked| error).
    """
    import torch

    from loupiote_tpu_torch.ops import wide

    ro, rd, active = closest
    R = ro.shape[0]
    tfar = torch.full((R,), 1e30, device=ro.device)
    table = (scene.trav_rows,)
    sizes = (scene.wide_end, scene.wide_stack)
    kt, ktri = wide.wide_trace(*table, ro, rd, tfar, active, False, *sizes)
    kb = wide.wide_trace(*table, *shadow, True, *sizes)[1]
    stats = {} if stats is None else stats
    pt, ptri = wide.wide_trace_plain(*table, ro, rd, tfar, active, False,
                                     *sizes,
                                     stats=stats.setdefault("closest", {}))
    pb = wide.wide_trace_plain(*table, *shadow, True, *sizes,
                               stats=stats.setdefault("anyhit", {}))[1]
    torch.cuda.synchronize()
    tri_eq = bits_equal(ktri, ptri)
    max_ulp = int(ulp_diff(kt, pt).max())
    b_eq = bits_equal(kb, pb)
    t_err = float((kt - pt).abs().max())
    b_err = float((kb - pb).abs().max())
    hits = ktri >= 0
    copies = ("-" if n_first is None else
              f"{float((ktri[hits] >= n_first).float().mean()):.4f}")
    ok = tri_eq and max_ulp == 0 and b_eq
    rows.append(f"| {name} | {R} | {tri_eq} | {max_ulp} | {b_eq} | "
                f"{float(hits.float().mean()):.3f} / "
                f"{float(kb.float().mean()):.3f} | {copies} | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, t_err, b_err


def compare_bvh2(name, scene, closest, shadow, rows, stats=None):
    """K2 (both modes) and K3 against their twins on every ray of one wave,
    three kernel runs of each against one run of the twin.

    ``closest``: (ro, rd, active) for K2 closest-hit; ``shadow``: (ro, rd,
    tmax, active) for K2 any-hit and K3. K2, each mode: exact, as both
    follow one visit order: t, u, v and tri bit-equal on every ray, ties
    included (the row also reports tri agreement with t-ties excused, the
    largest t ulp and u, v equality). K3: blocked bits equal. ``stats``:
    receives the twins' work counts on the whole wave, by mode. Returns
    (ok, errors by mode).
    """
    import torch

    from loupiote_tpu_torch.ops import bvh2

    ro, rd, active = closest
    R = ro.shape[0]
    tfar = torch.full((R,), 1e30, device=ro.device)
    tables = (scene.node_rows, scene.leaf_rows)
    trace = (scene.num_nodes, scene.stack_depth)
    occ = (scene.end_index, scene.num_nodes)
    stats = {} if stats is None else stats
    for k in ("closest", "anyhit", "occluded"):
        stats.setdefault(k, {})
    modes = {"closest": (ro, rd, tfar, active), "anyhit": shadow}
    k_out = {m: [bvh2.bvh2_trace(*tables, *w, m == "anyhit", *trace)
                 for _ in range(3)] for m, w in modes.items()}
    k_occ = [bvh2.bvh2_occluded(*tables, *shadow, *occ) > 0
             for _ in range(3)]
    p_out = {m: bvh2.bvh2_trace_plain(*tables, *w, m == "anyhit", *trace,
                                      stats=stats[m])
             for m, w in modes.items()}
    p_occ = bvh2.bvh2_occluded_plain(*tables, *shadow, *occ,
                                     stats=stats["occluded"]) > 0
    torch.cuda.synchronize()
    ok, cells, errs = True, [], {}
    for m, w in modes.items():
        pt, pu, pv, ptri = p_out[m]
        agree_min, ties_max, ulp_max, uv_all = 1.0, 0, 0, True
        err, exact = 0.0, []
        for kt, ku, kv, ktri in k_out[m]:
            agree, ties, max_ulp, same = hits_agree(scene, w[0], w[1], kt,
                                                    ktri, pt, ptri)
            uv_same = bool((ku[same] == pu[same]).all()
                           & (kv[same] == pv[same]).all())
            uv_all &= uv_same
            agree_min = min(agree_min, agree)
            ties_max, ulp_max = max(ties_max, ties), max(ulp_max, max_ulp)
            exact.append(all(bits_equal(a, b) for a, b in
                             zip((kt, ku, kv, ktri), p_out[m])))
            ok &= exact[-1]
            if same.any():
                err = max(err, float((kt[same] - pt[same]).abs().max()))
        errs[m] = err
        cells.append(f"{agree_min:.6f} ({ties_max} ties) / {ulp_max} / "
                     f"{uv_all} / {exact}")
    occ_equal = [bool(torch.equal(k, p_occ)) for k in k_occ]
    ok &= all(occ_equal)
    errs["occluded"] = max(float((k.int() - p_occ.int()).abs().max())
                           for k in k_occ)
    k_any = k_out["anyhit"][0][3] >= 0
    cross = float((k_any == k_occ[0]).float().mean())
    rows.append(f"| {name} | {R} | {cells[0]} | {cells[1]} | {occ_equal} | "
                f"{cross:.6f} | "
                f"{float((k_out['closest'][0][3] >= 0).float().mean()):.3f} "
                f"/ {float(k_occ[0].float().mean()):.3f} | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, errs


def ptxas_lines(name):
    """ptxas's report (registers, stack frame, spills) of each kernel of
    ``csrc/<name>.cu``, a line a kernel, tagged with the kernel's name and
    its first template argument as a digit (``bvh2_trace_kernel<0>``)."""
    from loupiote_tpu_torch import _build

    out, entry = {}, None
    for line in _build.build_info[name]["log"].splitlines():
        if "Compiling entry function" in line:
            m = re.search(r".*\d([a-z]\w*?_kernel)(?:IL\w(\d+)E)?", line)
            entry = m[1] + (f"<{m[2]}>" if m[2] else "")
        elif entry and ("Used" in line or "stack frame" in line):
            out.setdefault(entry, []).append(
                line.split(":", 1)[-1].strip() if "Used" in line
                else line.strip())
    return "\n".join(f"  {k}: {'; '.join(v)}" for k, v in out.items())


def random_scene(device, copies=1):
    """4,000 random triangles; ``copies`` = 2 adds each again under a
    second index (t + 4,000), so every hit is an exact tie."""
    from loupiote_tpu_torch import build_scene_buffers
    from loupiote_tpu_torch.scene.types import Instance, Mesh, Scene

    rng = np.random.default_rng(7)
    n = 4000
    v0 = ((rng.random((n, 3)) - 0.5) * 20).astype(np.float32)
    v1 = v0 + (rng.random((n, 3)) - 0.5).astype(np.float32)
    v2 = v0 + (rng.random((n, 3)) - 0.5).astype(np.float32)
    v0, v1, v2 = (np.concatenate([v] * copies) for v in (v0, v1, v2))
    scene = Scene.default()
    pos = np.empty((n * copies * 3, 3), np.float32)
    pos[0::3], pos[1::3], pos[2::3] = v0, v1, v2
    scene.meshes.append(Mesh(pos, None, None,
                             np.arange(n * copies * 3, dtype=np.uint32)))
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


def ops_of(stats, box_key="visits"):
    """Operations of a whole wave from the twin's work counts on it."""
    return stats[box_key] * OPS_BOX + stats["tri_tests"] * OPS_TRI


def bits_equal(a, b):
    """Exact equality of two tensors of one dtype, floats by their bits."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def nan_equal(a, b):
    """Bit equality of two float32 tensors, NaN counted equal to NaN."""
    import torch

    if a.shape != b.shape:
        return False
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def compare_slab_sort(name, key, cols, rows, slab_log=16, repeats=3):
    """K4 against slab_sort_plain on the card on one input, ``repeats``
    times (a race between the blocks of a cluster would break equality
    only some of the time): the sorted (1 + payload, Rp) matrices bit for
    bit, and the wrapper's unpacked output (dtypes included) against the
    twin's. Returns (ok, max |err|, the packed input, c_log)."""
    import torch

    from loupiote_tpu_torch.ops import slab_sort as ss

    mat, c_log = ss.pack(key, cols, slab_log)
    p = ss.slab_sort_plain(mat.clone(), c_log)
    pks, pcols = ss.unpack(p, key, cols)
    slab = 1 << c_log
    same = unpacked = srt = True
    err = 0.0
    n_plan = len(ss.launch_plan(c_log, len(cols)))
    made = []
    for _ in range(repeats):
        before = ss.cuda_launched
        k = ss.sort_matrix(mat.clone(), c_log)
        made.append(ss.cuda_launched - before)
        ks, kcols = ss.slab_sort(key, cols, slab_log)
        torch.cuda.synchronize()
        srt &= bool((k[0].view(-1, slab).diff(dim=1) >= 0).all())
        same &= bits_equal(k, p)
        unpacked &= bits_equal(ks, pks) and all(
            bits_equal(a, b) and a.dtype == c.dtype
            for a, b, c in zip(kcols, pcols, cols))
        err = max(err, float((k.to(torch.int64) - p.to(torch.int64))
                             .abs().max()))
    launched = made == [n_plan] * repeats
    ok = same and unpacked and srt and launched
    rows.append(f"| {name} | {key.shape[0]} ({len(cols)} payload, "
                f"{k.shape[1] // slab} slabs of 2^{c_log}) | {repeats} | "
                f"{same} | {unpacked} | {srt} | {made} (plan {n_plan}) | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, err, mat, c_log


def pair_multiset_equal(key, ray_of, S, ray_out, sid_blocks, on, R):
    """The grouped (key, ray) multiset of block_regroup's output equals the
    input's (dump keys >= S dropped)."""
    import torch

    keep = key < S
    want = torch.sort(key[keep].to(torch.int64) * R + ray_of[keep])[0]
    sid = torch.repeat_interleave(sid_blocks.to(torch.int64), 1024)
    got = torch.sort((sid * R + ray_out)[on > 0])[0]
    return bool(torch.equal(want, got))


def compare_lanes(name, td, wave, rows):
    """E6 and E7 (both modes) against their twins on SUBSET strided rays of
    one wave. E6 runs on the whole wave and is compared on the subset; the
    subset's pairs (grouped by the card's K4 + E5) feed E7 and its twin.
    Returns (ok, max |err| of E6 and of E7 by mode)."""
    import torch

    from loupiote_tpu_torch.treelet import lane_bottom, lane_top
    from loupiote_tpu_torch.treelet.regroup import block_regroup

    ro, rd, act = wave
    R = ro.shape[0]
    idx = strided(R, ro.device)
    t0 = torch.full((R,), 1e30, device=ro.device)
    pk, nk = lane_top.lane_top_trace(td.top_fields, ro, rd, t0, act,
                                     td.num_top)
    sub = [x[idx].contiguous() for x in (ro, rd, t0, act)]
    pp, npp = lane_top.lane_top_plain(td.top_fields, *sub, td.num_top)
    torch.cuda.synchronize()
    top_ok = bits_equal(pk[idx], pp) and bits_equal(nk[idx], npp)
    errs = {"E6": float(max((pk[idx] - pp).abs().max(),
                            (nk[idx] - npp).abs().max()))}
    key, ray_of, fb = lane_top.compact_pairs(pp, npp, sub[3],
                                             S=td.num_subtrees)
    pray, sid, on = block_regroup(key, ray_of, td.num_subtrees)
    pr = pray.long()
    args = (sid, td.sub_fields, sub[0][pr].contiguous(),
            sub[1][pr].contiguous(), sub[2][pr].contiguous(), on)
    live_pairs = int((on > 0).sum())
    ok, cells = top_ok, []
    for mode in ("closest", "anyhit"):
        kt, ktri = lane_bottom.lane_bottom_trace(*args, mode == "anyhit")
        pt, ptri = lane_bottom.lane_bottom_plain(*args, mode == "anyhit")
        torch.cuda.synchronize()
        m_ulp = int(ulp_diff(kt, pt).max())
        tri_eq = bits_equal(ktri, ptri)
        errs[mode] = float((kt - pt).abs().max())
        ok &= m_ulp == 0 and tri_eq
        cells.append(f"{m_ulp} / {tri_eq} / "
                     f"{float(((ktri >= 0) & (on > 0)).float().sum()):.0f}")
    rows.append(f"| {name} | {len(idx)} of {R} | {top_ok} | "
                f"{float((npp == 8).float().mean()):.4f} | "
                f"{float(npp[sub[3]].float().mean()):.3f} | "
                f"{live_pairs} | {cells[0]} | {cells[1]} | "
                f"{'PASS' if ok else 'FAIL'} |")
    return ok, errs


def compare_lanes_nonfinite(td, wave, S, seed, rows):
    """E6 (both epilogues) and E7 (both epilogues, both modes) against
    their twins on NONFINITE_RAYS strided rays of one wave with the edge
    cases of nonfinite_rays. E6 walks the edge-case rays; E7 walks the
    pairs of the finite rays' walk (a ray with a NaN or infinite origin
    enters no subtree, so it would bring E7 no pair) with the edge-case
    rays in their place, so its slab tests meet the NaN terms. Floats
    NaN-equal, the rest bit-equal. Returns (E6 equal, E7 equal)."""
    import torch

    from loupiote_tpu_torch.scene.fixtures import nonfinite_rays
    from loupiote_tpu_torch.treelet import lane_bottom, lane_top
    from loupiote_tpu_torch.treelet.regroup import block_regroup

    ro, rd, act = wave
    R = ro.shape[0]
    idx = torch.arange(0, R, max(R // NONFINITE_RAYS, 1),
                       device=ro.device)[:NONFINITE_RAYS]
    fro, frd, fact = (x[idx].contiguous() for x in (ro, rd, act))
    n = fro.shape[0]
    t0 = torch.full((n,), 1e30, device=ro.device)
    nro, nrd = (x.contiguous() for x in nonfinite_rays(fro, frd, seed))
    bad = int((~(torch.isfinite(nro).all(1)
                 & torch.isfinite(nrd).all(1))).sum())

    def same(a, b):
        return all(nan_equal(x, y) if x.dtype == torch.float32
                   else bits_equal(x, y) for x, y in zip(a, b))

    e6_args = (td.top_fields, nro, nrd, t0, fact, td.num_top)
    pp, npp = lane_top.lane_top_plain(*e6_args)
    want_c = lane_top.compact_pairs(pp, npp, fact, S=S)
    top_ok = [same(lane_top.lane_top_trace(*e6_args), (pp, npp))
              for _ in range(3)]
    pairs_ok = [same(lane_top.lane_top_pairs(*e6_args, S), want_c)
                for _ in range(3)]
    # E7's pairs: the finite rays' walk, grouped as the path groups them.
    fp, fnp = lane_top.lane_top_plain(td.top_fields, fro, frd, t0, fact,
                                      td.num_top)
    key, ray_of, _ = lane_top.compact_pairs(fp, fnp, fact, S=S)
    pray, sid, on = block_regroup(key, ray_of, S)
    pr = pray.long()
    e7_pair = (sid, td.sub_fields, nro[pr].contiguous(),
               nrd[pr].contiguous(), t0[pr].contiguous(), on)
    e7_ray = (sid, td.sub_fields, td.sub_tri_base, pray, on, nro, nrd, t0)
    live = on > 0
    nf_pairs = int((live & ~(torch.isfinite(nro[pr]).all(1)
                             & torch.isfinite(nrd[pr]).all(1))).sum())
    e7_ok = {}
    for mode in ("closest", "anyhit"):
        a = mode == "anyhit"
        wp = lane_bottom.lane_bottom_plain(*e7_pair, a)
        wr = (lane_bottom.lane_bottom_rays_plain(*e7_ray, a),)
        e7_ok[("per pair", mode)] = [
            same(lane_bottom.lane_bottom_trace(*e7_pair, a), wp)
            for _ in range(3)]
        e7_ok[("per ray", mode)] = [
            same((lane_bottom.lane_bottom_rays(*e7_ray, a),), wr)
            for _ in range(3)]
    torch.cuda.synchronize()
    ok = (all(top_ok) and all(pairs_ok),
          all(all(v) for v in e7_ok.values()))
    rows.append(f"| E6 per ray / compacting | {n} ({bad}) | "
                f"{'/'.join(map(str, top_ok))} | "
                f"{'/'.join(map(str, pairs_ok))} | "
                f"{float((npp > 0).float().mean()):.4f} | "
                f"{'PASS' if all(top_ok) and all(pairs_ok) else 'FAIL'} |")
    for (epi, mode), v in e7_ok.items():
        rows.append(f"| E7 {epi} {mode} | {int(live.sum())} live pairs "
                    f"({nf_pairs} non-finite) | {'/'.join(map(str, v))} | | "
                    f"| {'PASS' if all(v) else 'FAIL'} |")
    return ok


class StageTimer:
    """The ``mark`` hook of treelet_intersect: a CUDA event at each stage's
    end; ``ms()`` sums the device time between marks by stage name."""

    def __init__(self):
        import torch

        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()

    def __call__(self, stage):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def ms(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def event_ms(fn, n):
    """Device milliseconds of each of n calls of fn, by CUDA events."""
    import torch

    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def blas_calls(fn, keep):
    """Run fn, keeping a copy of the arguments of the K1 and K2 calls that
    ``keep(kind, any_hit, index)`` picks (kind "K1" or "K2", index among
    that kernel and mode's calls in fn, in call order). Returns [(kind,
    any_hit, index, args)] in call order. Launches nothing itself."""
    from loupiote_tpu_torch.ops import bvh2, wide

    traces = {"K1": (wide, "wide_trace"), "K2": (bvh2, "bvh2_trace")}
    orig = {k: getattr(m, n) for k, (m, n) in traces.items()}
    seen, out = {}, []

    def recorder(kind):
        def call(*args):
            any_hit = bool(args[5] if kind == "K1" else args[6])
            i = seen.setdefault((kind, any_hit), 0)
            seen[(kind, any_hit)] = i + 1
            if keep(kind, any_hit, i):
                out.append((kind, any_hit, i, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args)))
            return orig[kind](*args)
        return call

    for k, (m, n) in traces.items():
        setattr(m, n, recorder(k))
    try:
        fn()
    finally:
        for k, (m, n) in traces.items():
            setattr(m, n, orig[k])
    return out


def k1_waves(fn, picks):
    """Run fn, keeping a copy of the rays K1 is given in the calls picked:
    ``picks`` maps ("closest" | "anyhit", index among that mode's calls in
    fn, in call order) to a label. Returns {label: (ro, rd, tmax,
    active)}. Launches nothing itself."""
    def mode(any_hit):
        return "anyhit" if any_hit else "closest"

    calls = blas_calls(fn, lambda kind, any_hit, i: kind == "K1"
                       and (mode(any_hit), i) in picks)
    return {picks[(mode(a), i)]: args[1:5] for _, a, i, args in calls}


def instanced_phase(lt, dev, smi, frames, gu):
    """The two-level frame on the card (bench.py's section_instanced):
    the textured arch-260k hall merged into one BLAS with 200 props of two
    meshes, through build_instanced_buffers and Renderer at 1920x1080, 3
    bounces, NEE, 1 spp; the same scene flattened timed in the same
    phase. Checks K1's and K2's launches a frame against the plan of the
    scene's mesh groups, holds every K1 and K2 call of the frame's primary
    and first NEE traversal to its plain twin on the same object-space
    rays, a 128x64 instanced frame to the CPU path, and an
    update_instance move to re-render with every BLAS tensor where it
    was. Returns the numbers for the kernels line."""
    import torch

    from loupiote_tpu_torch.ops import bvh2, wide
    from loupiote_tpu_torch.ops.intersect import _bvh2
    from loupiote_tpu_torch.render.integrator import (draw_uniforms,
                                                      trace_paths)
    from loupiote_tpu_torch.scene import instanced

    t0 = time.perf_counter()
    scene = lt.build_arch_scene(260_000, textured=True, props=200,
                                merged=True)
    t1 = time.perf_counter()
    inst = instanced.build_instanced_buffers(scene)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flat = lt.build_scene_buffers(scene)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    slots = np.asarray(inst.inst_mesh)
    groups = []  # (slot, instances, kernel, launches a traversal)
    for slot in sorted(set(inst.inst_mesh)):
        n = int((slots == slot).sum())
        kind = "K2" if _bvh2(inst.blas[slot]) else "K1"
        waves = (n if len(slots) <= instanced.TLAS_UNROLL_MAX or n <= 2
                 else min(instanced.TLAS_C, n))
        groups.append((slot, n, kind, waves))
    per_trav = {k: sum(g[3] for g in groups if g[2] == k)
                for k in ("K1", "K2")}
    print(f"instanced arch-260k + 200 props (merged hall): "
          f"{len(scene.instances)} instances; seconds: scene {t1 - t0:.2f}, "
          f"build_instanced_buffers {t2 - t1:.2f}, flattened buffers "
          f"{t3 - t2:.2f}; {inst.stats()}; BLASes "
          f"{[(b.num_tris, b.num_nodes) for b in inst.blas]} (triangles, "
          f"BVH2 nodes); mesh groups (slot, instances, kernel, launches a "
          f"traversal): {groups}; flattened BVH2 nodes {flat.num_nodes} "
          f"({smi})", flush=True)
    phase("instanced scene build", t0)

    # Frames: the instanced one and the same geometry flattened, a warm-up
    # and 5 timed each, launches counted over the 6.
    t0 = time.perf_counter()
    cfg = lt.RenderConfig(downsample_factor=1.0, denoise=False)
    view = lt.arch_camera()
    nf = 6
    out = {}
    for name, bufs in (("instanced", inst), ("instanced, flattened", flat)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = lt.Renderer((WIDTH, HEIGHT), cfg)
        r.set_resources(bufs)
        r.accumulate = True
        wide.reset_counters()
        bvh2.reset_counters()
        instanced.reset_counters()
        r.raytrace(view)
        first = r.accum.clone()
        ms = event_ms(lambda: r.raytrace(view), 5)
        img = r.blit()
        got = {"K1 closest": wide.launches_closest,
               "K1 any-hit": wide.launches_anyhit,
               "K2 closest": bvh2.launches_closest,
               "K2 any-hit": bvh2.launches_anyhit,
               "K3": bvh2.launches_occluded}
        drains = instanced.drain_iterations
        capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
        peak = torch.cuda.max_memory_allocated() / 2**30
        mean = float(np.mean(ms))
        nonzero = float((first.reshape(-1, 3).sum(1) > 0).float().mean())
        if bufs is inst:
            want = {"K1 closest": nf * BOUNCES * per_trav["K1"],
                    "K1 any-hit": nf * (BOUNCES + 1) * per_trav["K1"],
                    "K2 closest": nf * BOUNCES * per_trav["K2"],
                    "K2 any-hit": nf * (BOUNCES + 1) * per_trav["K2"],
                    "K3": 0}
            # Each drain iteration launches its group's kernel once (the
            # hall's group holds one instance and never drains).
            want_k2 = want["K2 closest"] + want["K2 any-hit"] + drains
            ok = (got["K1 closest"] == want["K1 closest"]
                  and got["K1 any-hit"] == want["K1 any-hit"]
                  and got["K2 closest"] + got["K2 any-hit"] == want_k2
                  and got["K3"] == 0)
        else:
            # Flattened: K1 past 8,192 BVH2 nodes (arch-260k), else K2 /
            # K3, 3 closest-hit and 4 shadow waves a frame.
            k2k3 = _bvh2(bufs)
            want = {"K1 closest": 0 if k2k3 else nf * BOUNCES,
                    "K1 any-hit": 0 if k2k3 else nf * (BOUNCES + 1),
                    "K2 closest": nf * BOUNCES if k2k3 else 0,
                    "K2 any-hit": 0,
                    "K3": nf * (BOUNCES + 1) if k2k3 else 0}
            ok = got == want
        rays = WIDTH * HEIGHT * BOUNCES * 2
        out[name] = {"ms_mean": mean, "ms_min": min(ms), "ms": ms,
                     "mrays_s": rays / mean / 1e3, "spp": 1,
                     "launches_per_frame": {k: v / nf for k, v in
                                            got.items()},
                     "k1_launches_per_frame": {
                         "closest": got["K1 closest"] / nf,
                         "anyhit": got["K1 any-hit"] / nf},
                     "drain_iterations": drains,
                     "nonzero_pixel_frac": nonzero, "peak_gib": peak}
        print(f"{name} frame: ms (CUDA events) mean {mean:.3f}, min "
              f"{min(ms):.3f}, all {[round(x, 3) for x in ms]}; Mrays/s "
              f"{rays / mean / 1e3:.3f}; launches over {nf} frames {got} "
              f"(want {want}, drain iterations {drains}); nonzero_pixel_frac "
              f"{nonzero:.4f}; image mean {float(r.accum.mean()):.5f}; peak "
              f"memory {peak:.2f} GiB; rays stopped by a step bound "
              f"{capped} ({smi})", flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: the {name} frame's launches "
                             f"{got} differ from the plan {want}")
        if capped or not torch.isfinite(r.accum).all() or not (
                img.shape == (HEIGHT, WIDTH, 3) and img.dtype == np.uint8):
            raise SystemExit(f"chip_smoke: the {name} frame is non-finite, "
                             f"misshapen or stopped rays at a step bound")
        if nonzero < 0.5:
            raise SystemExit(f"chip_smoke: the {name} frame is mostly black")
        if bufs is inst:
            r_inst, launches = r, got
        else:
            del r
    frames.update(out)
    mean_i = out["instanced"]["ms_mean"]
    mean_f = out["instanced, flattened"]["ms_mean"]
    print(f"instanced frame {mean_i:.3f} ms against the same geometry "
          f"flattened {mean_f:.3f} ms ({mean_i / mean_f:.2f}x) ({smi})")
    phase("instanced frame and its flattened twin: 6 + 6 frames", t0)

    # Where the instanced frame's device time goes: one frame's kernels
    # under torch.profiler, summed by name.
    t0 = time.perf_counter()
    ks = device_kernels(lambda: r_inst.raytrace(view))
    by = {}
    for kname, kms in ks:
        key = kernel_name(kname)
        by[key] = by.get(key, 0.0) + kms
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
    split = {"K1": by.get("wide_traverse_kernel", 0.0),
             "K2": sum(v for k, v in by.items() if "bvh2_trace" in k)}
    print(f"instanced frame under torch.profiler: {len(ks)} device "
          f"kernels, busy {busy:.3f} ms (K1 {split['K1']:.3f}, K2 "
          f"{split['K2']:.3f}, the rest {busy - sum(split.values()):.3f}); "
          f"top by device ms: "
          + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top), flush=True)
    out["instanced"]["device_busy_ms"] = busy
    out["instanced"]["device_ms_by_kernel"] = split
    phase("instanced frame's device kernels", t0)

    # Every K1 and K2 call of the primary traversal (bounce 0 closest-hit)
    # and of the first NEE traversal (the first any-hit one), recorded
    # from one frame, against the plain twins: tri bits equal and t
    # within 2 ulp on every ray (in practice bit-equal; K2 u, v too).
    t0 = time.perf_counter()
    n_k2 = {False: per_trav["K2"], True: per_trav["K2"]}
    n_k1 = per_trav["K1"]

    def keep(kind, any_hit, i):
        return i < (n_k1 if kind == "K1" else n_k2[any_hit])

    calls = blas_calls(lambda: r_inst.raytrace(view), keep)
    rows = ["| call | kernel, mode | rays | active | tri equal | t max ulp "
            "| hits | verdict |", "|---|---|---|---|---|---|---|---|"]
    ok, errs = True, {"K1": 0.0, "K2": 0.0}
    for j, (kind, _, _, args) in enumerate(calls):
        if kind == "K1":
            kt, ktri = wide._launch(*args)
            pt, ptri = wide.wide_trace_plain(*args)
            any_hit = args[5]
        else:
            kt, _, _, ktri = bvh2._launch_trace(*args)
            pt, _, _, ptri = bvh2.bvh2_trace_plain(*args)
            any_hit = args[6]
        ro, act = args[2 if kind == "K2" else 1], args[
            5 if kind == "K2" else 4]
        tri_eq = bits_equal(ktri, ptri)
        ulp = int(ulp_diff(kt, pt).max()) if kt.numel() else 0
        good = tri_eq and ulp <= 2
        ok &= good
        errs[kind] = max(errs[kind], float((kt - pt).abs().max()))
        rows.append(f"| {j} | {kind} {'any-hit' if any_hit else 'closest'}"
                    f" | {ro.shape[0]} | {int(act.sum())} | {tri_eq} | {ulp}"
                    f" | {int((ktri >= 0).sum())} | "
                    f"{'PASS' if good else 'FAIL'} |")
    print(f"K1 / K2 against their twins on the instanced frame's primary "
          f"and first NEE traversals ({len(calls)} calls):\n"
          + "\n".join(rows), flush=True)
    capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
    if not ok or capped or len(calls) != 2 * (n_k1 + per_trav["K2"]):
        raise SystemExit("chip_smoke: K1 or K2 disagrees with its plain "
                         "version on the instanced frame's object-space "
                         "rays, or rays reached a step bound")
    del calls
    phase("K1/K2 on the instanced frame's waves", t0)

    # update_instance: a prop moves; no BLAS tensor moves with it.
    t0 = time.perf_counter()
    ptrs = [[getattr(b, f).data_ptr() for f in ("trav_rows", "node_rows",
                                                 "leaf_rows", "tri_pack")]
            for b in inst.blas]
    m = np.array(scene.instances[1].model_to_world)
    m[:3, 3] += [0.0, 0.0, 3.0]
    moved = instanced.update_instance(inst, 1, m)
    r_inst.set_resources(moved)
    r_inst.reset_accumulation()
    r_inst.raytrace(view)
    same = moved.blas is inst.blas and ptrs == [
        [getattr(b, f).data_ptr() for f in ("trav_rows", "node_rows",
                                            "leaf_rows", "tri_pack")]
        for b in moved.blas]
    print(f"update_instance(1, +3 z): BLAS tuple and every BLAS tensor's "
          f"data_ptr unchanged {same}; frame finite "
          f"{bool(torch.isfinite(r_inst.accum).all())}", flush=True)
    if not same or not torch.isfinite(r_inst.accum).all():
        raise SystemExit("chip_smoke: update_instance moved a BLAS tensor "
                         "or the moved frame is not finite")
    del r_inst
    phase("update_instance re-render", t0)

    # A small instanced frame on the card against the CPU path.
    t0 = time.perf_counter()
    w, h = 128, 64
    gu.manual_seed(5)
    uni = draw_uniforms(w * h, BOUNCES, gu, "cpu")
    cam = torch.from_numpy(view)
    ref = trace_paths(inst.to("cpu"), cam, w, h, bounces=BOUNCES,
                      sort_rays=False, uniforms=uni)[0]
    got = trace_paths(inst, cam.to(dev), w, h, bounces=BOUNCES,
                      sort_rays=False, uniforms=uni.to(dev))[0].cpu()
    close = float(torch.isclose(got, ref, rtol=1e-4, atol=1e-5).all(1)
                  .float().mean())
    rel = abs(float(got.mean()) / max(float(ref.mean()), 1e-12) - 1.0)
    print(f"small instanced frame {w}x{h} card vs CPU plain path: pixels "
          f"close {close:.5f}, mean rel diff {rel:.2e}, mean "
          f"{float(ref.mean()):.5f}")
    if close < 0.995 or rel > 1e-3 or not float(ref.mean()) > 0:
        raise SystemExit("chip_smoke: the card's instanced frame disagrees "
                         "with the CPU path")
    phase("instanced frame vs CPU", t0)
    return {"launches": launches,
            "per_traversal": per_trav, "groups": groups, "errs": errs,
            "calls_checked": 2 * (n_k1 + per_trav["K2"])}


HALL_CAMERA = "0,5,34,0.15,-0.12,-1"  # arch_camera(): origin, direction
APP_WINDOW = (1280, 720)  # the reference app's window


def tiles_phase(lt, dev, arch, headline, smi):
    """Tile-parallel frames (parallel/tiles.py) on the card: (a) make_mesh()
    of the host's cards; (b) the headline frame through Renderer(mesh=) on
    a 3x1 mesh of this card (360-row slabs, tiled) and a 2x2 one (540-row
    slabs, untiled, the spp mean), a warm-up and 5 frames each, K1's
    launches a frame held to (3 + 4) x shards, 0 rays at a step bound, the
    unsharded headline renderer timed again beside them, one frame of
    each under torch.profiler (device kernels, busy ms, idle share); (c)
    at 1080p the gathered G-buffer of each mesh bit-equal to the
    unsharded one under one explicit jitter, and a 1x1 mesh bit-equal to
    trace_paths with the same uniforms, radiance included; (d) small
    sharded frames on the card against the same meshes of the CPU, the
    same shard uniforms, sort off; (e) the denoised frame on the 2x2
    mesh. Returns the frames for the kernels line and K1's launches over
    (b)."""
    import torch

    from loupiote_tpu_torch.ops import bvh2, wide
    from loupiote_tpu_torch.parallel import make_mesh, trace_paths_sharded
    from loupiote_tpu_torch.render.integrator import (draw_uniforms,
                                                      trace_paths)

    t0 = time.perf_counter()
    host = make_mesh()
    print(f"make_mesh() on this host: shape {host.shape}, {host}")
    meshes = {"tiles 3x1": make_mesh(3, 1, devices=[dev] * 3),
              "tiles 2x2": make_mesh(2, 2, devices=[dev] * 4)}
    view = lt.arch_camera()
    cfg = lt.RenderConfig(downsample_factor=1.0, denoise=False)

    def timed_frames(r):
        ms = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r.raytrace(view)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return ms

    def busy(r, ms_mean):
        """One more frame of r under torch.profiler: its device kernels,
        their summed device ms and the share of the mean frame time the
        device is idle."""
        ks = device_kernels(lambda: r.raytrace(view))
        b = sum(ms for _, ms in ks)
        out = {"device_kernels": len(ks), "device_busy_ms": b,
               "idle_share": 1.0 - b / ms_mean}
        print(f"  one frame under torch.profiler: {out}", flush=True)
        return out

    frames, launches = {}, {"closest": 0, "anyhit": 0}
    for name, mesh in meshes.items():
        shards = mesh.shape["tiles"] * mesh.shape["spp"]
        r = lt.Renderer((WIDTH, HEIGHT), cfg, mesh=mesh)
        r.set_resources(arch)
        r.accumulate = True
        wide.reset_counters()
        bvh2.reset_counters()
        r.raytrace(view)  # warm-up frame; accum == its sample
        first = r.accum.clone()
        ms = timed_frames(r)
        img = r.blit()
        got = {"closest": wide.launches_closest / 6,
               "anyhit": wide.launches_anyhit / 6}
        want = {"closest": BOUNCES * shards,
                "anyhit": (BOUNCES + 1) * shards}
        launches["closest"] += wide.launches_closest
        launches["anyhit"] += wide.launches_anyhit
        capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
        k23 = bvh2.launches_closest + bvh2.launches_occluded
        nonzero = float((first.reshape(-1, 3).sum(1) > 0).float().mean())
        mean = float(np.mean(ms))
        frames[name] = {
            "ms_mean": mean, "ms_min": min(ms), "ms": ms,
            "mrays_s": WIDTH * HEIGHT * BOUNCES * 2 / mean / 1e3, "spp": 1,
            "shards": shards, "slab_rows": HEIGHT // mesh.shape["tiles"],
            "k1_launches_per_frame": got, "nonzero_pixel_frac": nonzero,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"{name} frame ({mesh}): ms (CUDA events) mean {mean:.3f}, "
              f"min {min(ms):.3f}, all {[round(x, 3) for x in ms]}; K1 "
              f"launches a frame {got} (want {want}); K2/K3 launches {k23};"
              f" rays stopped by a step bound {capped}; nonzero_pixel_frac "
              f"{nonzero:.4f} ({smi})", flush=True)
        if got != want or k23:
            raise SystemExit(f"chip_smoke: the {name} frame launched K1 "
                             f"{got} times a frame, not {want}, or K2/K3")
        if capped:
            raise SystemExit("chip_smoke: rays reached the step bound")
        if not (torch.isfinite(r.accum).all() and img.shape ==
                (HEIGHT, WIDTH, 3) and img.dtype == np.uint8):
            raise SystemExit(f"chip_smoke: non-finite or misshapen {name} "
                             f"frame")
        if nonzero < 0.5:
            raise SystemExit(f"chip_smoke: the {name} frame is mostly black")
        frames[name].update(busy(r, mean))
        del r
    head_ms = timed_frames(headline)
    head = {"ms_mean": float(np.mean(head_ms)),
            **busy(headline, float(np.mean(head_ms)))}
    for f in frames.values():
        f["headline"] = head
    print(f"the unsharded headline frame again, after the tile frames: ms "
          f"mean {head['ms_mean']:.3f}, all {[round(x, 3) for x in head_ms]}"
          f" ({smi})", flush=True)
    phase("tiles (b): 3x1 and 2x2 1080p frames, 6 + 6, headline 5", t0)

    # (c) The tile split is exact at 1080p.
    t0 = time.perf_counter()
    cam = torch.from_numpy(view).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    N = WIDTH * HEIGHT
    jitter = torch.rand(N, 2, generator=g, device=dev)
    nee_uv = torch.rand(N, 2, generator=g, device=dev)
    _, whole = trace_paths(arch, cam, WIDTH, HEIGHT, g, bounces=1,
                           jitter=jitter, nee_uv=nee_uv)
    planes = ("depth", "mesh_id", "normal", "albedo", "world_pos")
    for name, mesh in meshes.items():
        _, gb = trace_paths_sharded(arch, cam, (21,), mesh=mesh, width=WIDTH,
                                    height=HEIGHT, bounces=1, jitter=jitter,
                                    nee_uv=nee_uv)
        equal = {p: bool(torch.equal(gb[p].reshape(getattr(whole, p).shape),
                                     getattr(whole, p))) for p in planes}
        print(f"{name}: gathered 1080p G-buffer bit-equal to the unsharded "
              f"one: {equal}", flush=True)
        if not all(equal.values()):
            raise SystemExit(f"chip_smoke: the {name} G-buffer differs from "
                             f"the unsharded one")
    u = draw_uniforms(N, BOUNCES, g, dev)
    rad, gb1 = trace_paths(arch, cam, WIDTH, HEIGHT, bounces=BOUNCES,
                           uniforms=u)
    img1, gbs = trace_paths_sharded(arch, cam, mesh=make_mesh(
        1, 1, devices=[dev]), width=WIDTH, height=HEIGHT, bounces=BOUNCES,
        uniforms=[[u]])
    same = bool(torch.equal(img1.reshape(-1, 3), rad)) and all(
        torch.equal(gbs[p].reshape(getattr(gb1, p).shape), getattr(gb1, p))
        for p in planes)
    print(f"1x1 mesh with the uniforms of a trace_paths call: radiance and "
          f"G-buffer bit-equal {same}", flush=True)
    if not same:
        raise SystemExit("chip_smoke: a 1x1 mesh differs from trace_paths")
    del whole, gb, rad, gb1, img1, gbs, u, jitter, nee_uv
    phase("tiles (c): 1080p G-buffers bit-equal to the unsharded frame", t0)

    # (d) Small sharded frames, the card against the CPU, the same shard
    # uniforms, sort off; 18-row slabs are untiled.
    t0 = time.perf_counter()
    arch_cpu = arch.to("cpu")
    gu = torch.Generator(device="cpu")
    gu.manual_seed(14)
    for (n_tiles, n_spp), h in (((3, 1), 48), ((2, 2), 48), ((2, 1), 36)):
        w, rows = 128, h // n_tiles
        uni = [[draw_uniforms(rows * w, BOUNCES, gu, "cpu")
                for _ in range(n_spp)] for _ in range(n_tiles)]
        cpu_mesh = make_mesh(n_tiles, n_spp,
                             devices=[torch.device("cpu")] * (n_tiles * n_spp))
        dev_mesh = make_mesh(n_tiles, n_spp, devices=[dev] * (n_tiles * n_spp))
        ref = trace_paths_sharded(arch_cpu, cam.cpu(), mesh=cpu_mesh,
                                  width=w, height=h, bounces=BOUNCES,
                                  uniforms=uni, sort_rays=False)[0]
        out = trace_paths_sharded(arch, cam, mesh=dev_mesh, width=w,
                                  height=h, bounces=BOUNCES, uniforms=uni,
                                  sort_rays=False)[0].cpu()
        close = float(torch.isclose(out, ref, rtol=1e-4, atol=1e-5).all(-1)
                      .float().mean())
        rel = abs(float(out.mean()) / max(float(ref.mean()), 1e-12) - 1.0)
        print(f"{n_tiles}x{n_spp} mesh, {w}x{h} ({rows}-row slabs) card vs "
              f"CPU: pixels close {close:.5f}, mean rel diff {rel:.2e}",
              flush=True)
        if close < 0.995 or rel > 1e-3:
            raise SystemExit("chip_smoke: the card's sharded frame disagrees "
                             "with the CPU's")
    del arch_cpu
    phase("tiles (d): small sharded frames vs CPU", t0)

    # (e) The denoised frame on the 2x2 mesh.
    t0 = time.perf_counter()
    r = lt.Renderer((WIDTH, HEIGHT), lt.RenderConfig(downsample_factor=1.0),
                    mesh=meshes["tiles 2x2"])
    r.set_resources(arch)
    r.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    for _ in range(3):
        r.raytrace(view)
    hist = float(r.state.asvgf_history.mean())
    finite = bool(torch.isfinite(r.state.denoised).all())
    print(f"tiles 2x2 denoised, 3 frames: finite {finite}, asvgf_history "
          f"mean {hist:.4f}, image mean {float(r.state.denoised.mean()):.5f}",
          flush=True)
    if not finite or hist <= 1.0 or r.blit().shape != (HEIGHT, WIDTH, 3):
        raise SystemExit("chip_smoke: the 2x2 mesh's denoised frame is not "
                         "finite or did not reproject")
    del r
    torch.cuda.empty_cache()
    phase("tiles (e): denoised 2x2 frame", t0)
    return frames, launches


def http_json(url, data=None, timeout=30):
    import urllib.request

    req = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return r.status, dict(r.headers), body


def app_phases(lt, dev, arch, arch40, smi):
    """The app layer on the card: the textured hall through a glb, the
    CLI, measure_passes, the viewer server, hot reload and the lightmap
    bake. Raises on any failed check; returns the numbers printed."""
    import os
    import shutil
    import tempfile

    import torch

    from loupiote_tpu_torch import _build, image_codec
    from loupiote_tpu_torch.app import Driver
    from loupiote_tpu_torch.app.server import ViewerServer
    from loupiote_tpu_torch.app.trace_parse import (frame_scope_labels,
                                                    matched_share)
    from loupiote_tpu_torch.ops.intersect import path_libraries
    from loupiote_tpu_torch.ops.lightmap import bake_vertex_irradiance
    from loupiote_tpu_torch.render import CameraController
    from loupiote_tpu_torch.scene.fixtures import write_glb

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_app_")
    try:
        # -- the textured hall written as a glb, loaded by the Driver ------
        t0 = time.perf_counter()
        hall = lt.build_arch_scene(260_000, textured=True, props=200)
        glb = os.path.join(tmp, "hall.glb")
        # Its textures as JPEG (the port's encoder; the loader decodes
        # them with decode_jpeg): the texels to expect are the round trip.
        write_glb(hall, glb, image_format="jpeg")
        texels = [image_codec.decode_jpeg(image_codec.encode_jpeg(
            np.ascontiguousarray(img.data, np.uint8))) for img in hall.images]
        drv = Driver(APP_WINDOW, lt.RenderConfig(), device=dev)
        drv.load_gltf_path(glb)
        got = drv.scene
        same_mesh = len(got.meshes) == len(hall.meshes) and all(
            np.array_equal(a.positions, b.positions)
            and np.array_equal(a.indices, b.indices)
            and (a.texcoords is None) == (b.texcoords is None)
            and (a.texcoords is None or np.array_equal(a.texcoords,
                                                       b.texcoords))
            for a, b in zip(got.meshes, hall.meshes))
        # The loader appends after Scene.default()'s material.
        same_inst = len(got.instances) == len(hall.instances) and all(
            a.mesh_index == b.mesh_index
            and a.material_index == b.material_index + 1
            and np.array_equal(a.model_to_world, b.model_to_world)
            for a, b in zip(got.instances, hall.instances))
        same_mat = len(got.materials) == len(hall.materials) + 1 and all(
            np.array_equal(a.color, b.color) and a.roughness == b.roughness
            and a.reflectivity == b.reflectivity
            and a.albedo_texture == b.albedo_texture
            and a.mra_texture == b.mra_texture
            for a, b in zip(got.materials[1:], hall.materials))
        same_tex = len(got.images) == len(hall.images) and all(
            np.array_equal(a.data, b) for a, b in zip(got.images, texels))
        print(f"app: textured arch-260k + 200 props as a glb "
              f"({os.path.getsize(glb)} bytes, {len(hall.images)} JPEG "
              f"textures) through Driver.load_gltf_path: meshes equal "
              f"{same_mesh}, instances {same_inst}, materials {same_mat}, "
              f"texels {same_tex}; {got.stats()}", flush=True)
        phase("app: hall as glb", t0)
        if not (same_mesh and same_inst and same_mat and same_tex):
            raise SystemExit("chip_smoke: the glb's scene differs from the "
                             "in-memory hall")

        # -- the CLI, as users start it, at the headline's resolution ------
        # glTF carries no light, so --fit-light puts the hall's overhead
        # quad back, and --camera is the headline's view.
        t0 = time.perf_counter()
        png = os.path.join(tmp, "out.png")
        cmd = [sys.executable, "-m", "loupiote_tpu_torch", "render", glb,
               png, "--size", f"{WIDTH}x{HEIGHT}", "--scale", "1.0", "--spp",
               "16", "--mode", "denoised", "--fit-light", "10", "--camera",
               HALL_CAMERA, "--device", dev.type]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            raise SystemExit(f"chip_smoke: the CLI render exited "
                             f"{proc.returncode}")
        img = image_codec.read_png(png)
        cli_nonzero = float((img[..., :3].astype(int).sum(-1) > 0).mean())
        m = re.search(r"([0-9.]+) ms a frame", proc.stdout)
        cli_ms = float(m.group(1)) if m else None
        out["cli"] = {"ms_per_frame": cli_ms, "process_s": cli_s,
                      "nonzero": cli_nonzero, "shape": list(img.shape)}
        print(f"app: CLI render {WIDTH}x{HEIGHT} denoised, 16 frames: {cli_ms} ms a "
              f"frame after the first; process {cli_s:.1f} s; PNG "
              f"{img.shape}, nonzero share {cli_nonzero:.4f} ({smi})",
              flush=True)
        phase("app: CLI render", t0)
        if img.shape != (HEIGHT, WIDTH, 4) or cli_nonzero < 0.9:
            raise SystemExit("chip_smoke: the CLI's image is misshapen or "
                             "mostly black")

        # -- measure_passes on the headline frame, pathtrace and denoised --
        t0 = time.perf_counter()
        r = lt.Renderer((WIDTH, HEIGHT),
                        lt.RenderConfig(downsample_factor=1.0, denoise=False),
                        device=dev)
        r.set_resources(arch)
        r.accumulate = True
        view = lt.arch_camera()
        passes, ok = {}, True
        for mode in (lt.BlitMode.PATHTRACE, lt.BlitMode.DENOISED_PATHTRACE):
            r.set_blit_mode(mode)
            r.raytrace(view)
            res = r.measure_passes(view)
            labels = frame_scope_labels(
                BOUNCES, denoised=mode != lt.BlitMode.PATHTRACE)
            shares = {k: v for k, v in res.items()
                      if k in labels.values() or k == "other"}
            share = matched_share(shares)
            good = (res.get("method") == "trace"
                    and all(lab in res and res[lab] >= 0
                            for lab in labels.values())
                    and share > 0.3)
            ok &= good
            passes[mode.value] = {"passes": res, "matched_share": share}
            rows = ["| pass | device ms | share |", "|---|---|---|"]
            total = sum(shares.values())
            for lab, v in shares.items():
                rows.append(f"| {lab} | {v:.3f} | {v / max(total, 1e-9):.3f} |")
            print(f"app: measure_passes, arch-260k {WIDTH}x{HEIGHT} {mode.value} "
                  f"(method {res.get('method')}): device time under a label "
                  f"{share:.4f} of {total:.3f} ms; frame (fused) "
                  f"{res.get('frame (fused)', 0.0):.3f} ms ({smi})\n"
                  + "\n".join(rows), flush=True)
        out["measure_passes"] = passes
        del r
        phase("app: measure_passes", t0)
        if not ok:
            raise SystemExit("chip_smoke: measure_passes did not trace every "
                             "label, or too little device time fell under "
                             "them")

        # -- the viewer server around the Driver, on loopback ---------------
        t0 = time.perf_counter()
        drv.scene.fit_default_light(10.0)
        drv.upload_scene()
        vals = [float(v) for v in HALL_CAMERA.split(",")]
        d = np.array(vals[3:], np.float32)
        drv.camera_controller = CameraController.from_origin_dir(
            np.array(vals[:3], np.float32), d / np.linalg.norm(d))
        shots = os.path.join(tmp, "shots")
        srv = ViewerServer(drv, host="127.0.0.1", port=0,
                           screenshot_dir=shots).start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            status, _, page = http_json(base + "/")
            jpeg_ok, after, splits = status == 200 and b"<html" in page, -1, []
            for _ in range(20):
                status, hdr, body = http_json(f"{base}/frame?after={after}")
                jpeg_ok &= (status == 200 and body[:2] == b"\xff\xd8"
                            and body[-2:] == b"\xff\xd9")
                after = int(hdr["X-Frame-Id"])
                splits.append(dict(srv.loop_ms))
            origin0 = drv.camera_controller.origin.copy()
            _, _, before = http_json(f"{base}/frame?after={after}")
            http_json(base + "/input", {"type": "key", "key": "w",
                                        "pressed": True})
            moved, changed = False, False
            for _ in range(10):
                status, hdr, body = http_json(f"{base}/frame?after={after}")
                after = int(hdr["X-Frame-Id"])
                moved = not np.array_equal(drv.camera_controller.origin,
                                           origin0)
                changed = body != before
                if moved and changed:
                    break
            http_json(base + "/input", {"type": "key", "key": "w",
                                        "pressed": False})
            _, _, stats_body = http_json(base + "/stats")
            stats = json.loads(stats_body)
            stats_ok = stats.get("triangles", 0) > 0 and stats.get("fps", 0) > 0
            http_json(base + "/input", {"type": "setting", "name": "blit_mode",
                                        "value": "gbuffer"})
            mode_ok = False
            for _ in range(10):
                _, hdr, _ = http_json(f"{base}/frame?after={after}")
                after = int(hdr["X-Frame-Id"])
                stats = json.loads(http_json(base + "/stats")[2])
                mode_ok = (drv.renderer.mode == lt.BlitMode.GBUFFER
                           and stats.get("blit_mode") == "gbuffer")
                if mode_ok:
                    break
            http_json(base + "/input", {"type": "screenshot",
                                        "path": "/elsewhere/x.png"})
            shot_ok = False
            for _ in range(20):
                _, hdr, _ = http_json(f"{base}/frame?after={after}")
                after = int(hdr["X-Frame-Id"])
                listed = os.listdir(shots) if os.path.isdir(shots) else []
                if listed:
                    shot = image_codec.read_png(os.path.join(shots,
                                                             listed[0]))
                    shot_ok = shot.shape == APP_WINDOW[::-1] + (4,)
                    break
            err = getattr(srv, "render_error", None)
        finally:
            srv.stop()
        mean = {k: float(np.mean([s[k] for s in splits if k in s]))
                for k in ("step", "blit", "encode")}
        out["server"] = {"loop_ms": mean, "stats": stats}
        print(f"app: viewer server {APP_WINDOW} (downsample 0.5, denoised) on "
              f"127.0.0.1:{srv.port}: 20 JPEG frames {jpeg_ok}; 'w' moved "
              f"the camera {moved} and changed the frame {changed}; /stats "
              f"triangles {stats.get('triangles')} fps "
              f"{stats.get('fps', 0):.2f} ({stats_ok}); gbuffer mode "
              f"{mode_ok}; screenshot in the server's directory {shot_ok}; "
              f"loop ms (mean of the 20 frames): step {mean['step']:.3f}, "
              f"blit {mean['blit']:.3f}, JPEG encode {mean['encode']:.3f} "
              f"({smi})", flush=True)
        phase("app: viewer server", t0)
        if not (jpeg_ok and moved and changed and stats_ok and mode_ok
                and shot_ok) or err:
            raise SystemExit(f"chip_smoke: the viewer server failed a check "
                             f"(render error: {err})")

        # -- hot reload: clean, then with a source that does not compile ---
        t0 = time.perf_counter()
        rr = drv.renderer
        rr.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
        view = drv.camera_controller.update(0.0)

        def frame_from(gen_state, state):
            rr.generator.set_state(gen_state)
            rr.state = state
            rr.raytrace(view)
            return rr.state.denoised.clone()

        gs, st0 = rr.generator.get_state(), rr.state
        a = frame_from(gs, st0)
        rr.reload_shaders()
        clean_err = rr.last_reload_error
        b = frame_from(gs, st0)
        libs = path_libraries(rr.scene)
        old_libs = {n: _build._libs[n] for n in libs}
        broken = os.path.join(tmp, "csrc")
        shutil.copytree(_build.CSRC_DIR, broken)
        with open(os.path.join(broken, f"{libs[0]}.cu"), "a") as f:
            f.write("\nthis does not compile;\n")
        csrc = _build.CSRC_DIR
        try:
            _build.CSRC_DIR = broken
            rr.reload_shaders()
        finally:
            _build.CSRC_DIR = csrc
        bad_err = rr.last_reload_error
        kept = all(_build._libs.get(n) is old_libs[n] for n in libs)
        c = frame_from(gs, st0)
        same_clean, same_bad = bits_equal(a, b), bits_equal(a, c)
        out["reload"] = {"clean_error": clean_err, "broken_error":
                         (bad_err or "")[:200], "libraries": libs}
        print(f"app: hot reload of {libs}: clean reload error {clean_err}, "
              f"frame bit-equal {same_clean}; with {libs[0]}.cu broken: "
              f"error set {bad_err is not None} "
              f"({(bad_err or '').splitlines()[0][:120]}), old libraries "
              f"kept {kept}, frame bit-equal {same_bad}", flush=True)
        phase("app: hot reload", t0)
        if not (clean_err is None and same_clean and bad_err and kept
                and same_bad):
            raise SystemExit("chip_smoke: hot reload changed the frame or "
                             "did not keep the old pipeline")
        del drv, rr, srv

        # -- the lightmap bake on arch-40k, against its CPU run -------------
        t0 = time.perf_counter()
        # Surface points: the centroids of V of the hall's triangles, with
        # their geometric normals.
        V = 512
        real = torch.nonzero(arch40.tri_pack[:, 0].abs() < 1e29).flatten()
        pick = real[torch.linspace(0, len(real) - 1, V, device=dev).long()]
        tp = arch40.tri_pack[pick]
        pos = tp[:, 0:3] + (tp[:, 3:6] + tp[:, 6:9]) / 3.0
        nrm = arch40.tri_shade[pick, 17:20]
        bakes = []
        for scene in (arch40, arch40.to("cpu")):
            g = torch.Generator(device="cpu")
            g.manual_seed(5)
            bakes.append(bake_vertex_irradiance(scene, pos, nrm, g,
                                                samples=4).cpu())
        close = float(torch.isclose(bakes[0], bakes[1], rtol=1e-4,
                                    atol=1e-5).all(1).float().mean())
        rel = abs(float(bakes[0].mean()) / max(float(bakes[1].mean()),
                                               1e-12) - 1.0)
        lit = float((bakes[0].sum(1) > 0).float().mean())
        out["lightmap"] = {"vertices": V, "close": close, "mean_rel": rel,
                           "lit": lit}
        print(f"app: bake_vertex_irradiance on {V} arch-40k surface points "
              f"(K2/K3), 4 samples x 2 bounces: card vs CPU close {close:.5f},"
              f" mean rel diff {rel:.2e}, lit share {lit:.4f}", flush=True)
        phase("app: lightmap bake vs CPU", t0)
        if close < 0.995 or rel > 1e-3 or lit < 0.5:
            raise SystemExit("chip_smoke: the card's bake disagrees with the "
                             "CPU's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main():
    t_all = time.perf_counter()
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch import _build, image_codec
    from loupiote_tpu_torch.accel import native
    from loupiote_tpu_torch.denoise.asvgf import denoise
    from loupiote_tpu_torch.experiments import (
        device_sort_bench, kernel_probe, lane_gather_bench,
        measure_traversal, r3_probes)
    from loupiote_tpu_torch.ops import bvh2, wide
    from loupiote_tpu_torch.ops import slab_sort as ss
    from loupiote_tpu_torch.ops.sort import DEAD_KEY, ray_sort_key, sort_order
    from loupiote_tpu_torch.treelet import (lane_bottom, lane_top, pipeline,
                                            regroup)
    from loupiote_tpu_torch.treelet.device_sort import device_sort
    from loupiote_tpu_torch.render import renderer as rmod
    from loupiote_tpu_torch.render.integrator import (draw_uniforms,
                                                      trace_paths)
    from loupiote_tpu_torch.scene.fixtures import (TEX_CAM, nonfinite_rays,
                                                   sky_equirect,
                                                   textured_quad_scene)

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
    kernels_src = ("wide_traverse", "bvh2_traverse", "slab_sort",
                   "treelet_traverse", "regroup", "kernel_probe",
                   "lane_gather", "r3_probes")
    with ThreadPoolExecutor(len(kernels_src) + 1) as pool:
        futs = [pool.submit(_build.load, k) for k in kernels_src]
        t1 = time.perf_counter()
        fut_bvh = pool.submit(native._load)
        fut_codec = pool.submit(image_codec._load)
        for f in futs + [fut_bvh, fut_codec]:
            f.result()
    for k in kernels_src:
        info = _build.build_info[k]
        print(f"nvcc {k}.cu: {info['seconds']:.2f} s\n{info['log']}")
    print(f"BVH builder: native C++ ({native.SOURCE}, g++ -O3, "
          f"{native.OPT_ROUNDS} insertion-optimizer rounds); all builds "
          f"done {time.perf_counter() - t1:.2f} s after start")
    phase("build", t0)

    # -- K1 against its plain twin ----------------------------------------
    # Every ray of each wave, exact: tri (ties included), t bits, blocked
    # bits. The tie wave duplicates every triangle of the random scene, so
    # every hit is a tie and the winner shows the visit order.
    t0 = time.perf_counter()
    rows = ["| wave | rays compared | tri equal | t max ulp | blocked equal "
            "| hit / blocked frac | hits won by the copy | verdict |",
            "|---|---|---|---|---|---|---|---|"]
    ok, k1_err = True, [0.0, 0.0]

    def k1_check(*a, **kw):
        nonlocal ok
        ok_w, t_e, b_e = compare_wide(*a, **kw)
        ok &= ok_w
        k1_err[0], k1_err[1] = max(k1_err[0], t_e), max(k1_err[1], b_e)

    rscene, rng = random_scene(dev)
    R = 64 * 1024
    ro = torch.from_numpy(((rng.random((R, 3)) - 0.5) * 30)
                          .astype(np.float32)).to(dev)
    rd = torch.from_numpy((rng.random((R, 3)) - 0.5).astype(np.float32))
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(dev)
    on = torch.ones(R, dtype=torch.bool, device=dev)
    r_shadow = (ro, rd, torch.full((R,), 25.0, device=dev), on)
    k1_check("random-4k / random rays (shadow: tmax 25)", rscene,
             (ro, rd, on), r_shadow, rows)
    tscene, _ = random_scene(dev, copies=2)
    k1_check("tie wave: random-4k with every triangle twice / the same "
             "rays", tscene, (ro, rd, on), r_shadow, rows, n_first=4000)
    phase("K1: random-4k and its tie wave", t0)

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
          f"{arch.wide_end}, wide_stack {arch.wide_stack}, K1 stack depth "
          f"{wide.kernel_depth(arch.trav_rows)} levels (of "
          f"{wide.DEPTH_MAX}), trav_rows {trav_bytes} bytes "
          f"({trav_bytes / 1e6:.2f} MB; L2 50 MB)")
    print("K1 ptxas (registers, stack frame, spills):\n" + "\n".join(
        line for line in _build.build_info["wide_traverse"]["log"]
        .splitlines() if "Used" in line or "stack frame" in line))
    phase("scene build", t0)

    t0 = time.perf_counter()
    cam = torch.from_numpy(lt.arch_camera()).to(dev)
    N = WIDTH * HEIGHT
    prim, nee, diff = waves(arch, cam, WIDTH, HEIGHT, seed=0)
    k1_stats = {}
    k1_check("arch-260k / primary 1080p (shadow: NEE to the light)", arch,
             prim, nee, rows, stats=k1_stats)
    dro, drd, dact = diff
    order = sort_order(ray_sort_key(dro, drd, dact, arch.node_min[0],
                                    arch.node_max[0]))
    dro, drd, dact = (dro[order].contiguous(), drd[order].contiguous(),
                      dact[order].contiguous())
    diff260 = (dro, drd, dact)
    k1_check("arch-260k / diffuse 1080p, sorted (shadow: tmax 25)", arch,
             (dro, drd, dact),
             (dro, drd, torch.full((N,), 25.0, device=dev), dact), rows)
    capped = wide.capped_rays(dev)
    rows.append(f"rays stopped by the step bound (kernel and twin, all "
                f"waves): {capped}")
    print("\n".join(rows), flush=True)
    ok &= capped == 0
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
    k1_bound = {m: bound(N, 8, trav_bytes,
                         ops_of(k1_stats[m], box_key="box_tests"))
                for m in ("closest", "anyhit")}
    for m, (b_ms, b_by) in k1_bound.items():
        print(f"K1 {m} bound on the 1080p wave: {b_ms:.4f} ms ({b_by}; "
              f"twin work on the wave's {N} rays: {k1_stats[m]})")
    phase("K1 timing", t0)
    if not ok:
        raise SystemExit("chip_smoke: K1 disagrees with its plain version, "
                         "or rays reached the step bound")

    # -- K2 and K3 against their plain twins --------------------------------
    t0 = time.perf_counter()
    rows = ["| wave | rays | K2 closest, 3 runs: tri agree (ties) / t max "
            "ulp / u,v equal / bits equal | K2 any-hit, the same | K3 bits "
            "equal, 3 runs | K2 any-hit = K3 | hit / blocked frac | "
            "verdict |",
            "|---|---|---|---|---|---|---|---|"]
    ok, k23_err = compare_bvh2("random-4k / random rays (shadow: tmax 25)",
                               rscene, (ro, rd, on), r_shadow, rows)
    ok_t, errs = compare_bvh2("tie wave: random-4k with every triangle twice "
                              "/ the same rays", tscene, (ro, rd, on),
                              r_shadow, rows)
    ok &= ok_t
    k23_err = {k: max(v, errs[k]) for k, v in k23_err.items()}
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
    k23_stats, diff_stats = {}, {}
    dro, drd, dact = diff40
    dshadow40 = (dro, drd, torch.full((N40,), 25.0, device=dev), dact)
    for wname, closest40, shadow40, st in (
            (f"arch-40k / primary {w40}x{h40} (shadow: NEE to the light)",
             prim40, nee40, k23_stats),
            (f"arch-40k / diffuse {w40}x{h40}, unsorted (shadow: tmax 25)",
             diff40, dshadow40, diff_stats)):
        ok_w, errs = compare_bvh2(wname, arch40, closest40, shadow40, rows,
                                  stats=st)
        ok &= ok_w
        k23_err = {k: max(v, errs[k]) for k, v in k23_err.items()}
    capped = bvh2.capped_rays(dev)
    rows.append(f"rays stopped by the step bound (K2, K3 and their twins, "
                f"all waves): {capped}")
    ok &= capped == 0
    print("\n".join(rows), flush=True)
    print("K2/K3 ptxas (registers, stack frame, spills; bvh2_trace_kernel "
          "is K2, <0> closest-hit, <1> any-hit; bvh2_occluded_kernel K3):\n"
          + ptxas_lines("bvh2_traverse"))
    phase("K2/K3: five waves", t0)
    if not ok:
        raise SystemExit("chip_smoke: K2 or K3 disagrees with its plain "
                         "version, or rays reached the step bound")

    # Times on the interactive path's waves: K2 closest-hit on the primary
    # wave, K2 any-hit and K3 on its NEE wave, K3 on the diffuse shadow
    # wave; K1 on the same waves.
    t0 = time.perf_counter()
    tfar40 = torch.full((N40,), 1e30, device=dev)
    p40 = (prim40[0], prim40[1], tfar40, prim40[2])
    tb40 = (arch40.node_rows, arch40.leaf_rows)
    tr40 = (arch40.num_nodes, arch40.stack_depth)
    oc40 = (arch40.end_index, arch40.num_nodes)
    d40 = (diff40[0], diff40[1], tfar40, diff40[2])
    calls = {
        "K2 closest": (lambda: bvh2.bvh2_trace(*tb40, *p40, False, *tr40),
                       lambda: bvh2.bvh2_trace_plain(*tb40, *p40, False,
                                                     *tr40)),
        "K2 diffuse": (lambda: bvh2.bvh2_trace(*tb40, *d40, False, *tr40),
                       lambda: bvh2.bvh2_trace_plain(*tb40, *d40, False,
                                                     *tr40)),
        "K2 any-hit": (lambda: bvh2.bvh2_trace(*tb40, *nee40, True, *tr40),
                       lambda: bvh2.bvh2_trace_plain(*tb40, *nee40, True,
                                                     *tr40)),
        "K3": (lambda: bvh2.bvh2_occluded(*tb40, *nee40, *oc40),
               lambda: bvh2.bvh2_occluded_plain(*tb40, *nee40, *oc40)),
        "K3 diffuse": (lambda: bvh2.bvh2_occluded(*tb40, *dshadow40, *oc40),
                       lambda: bvh2.bvh2_occluded_plain(*tb40, *dshadow40,
                                                        *oc40)),
    }
    k23_timing = {}
    for name, (kfn, pfn) in calls.items():
        k23_timing[name] = (cuda_ms(kfn, 20), cuda_ms(pfn, 1))
    wide40 = (arch40.trav_rows,)
    ws40 = (arch40.wide_end, arch40.wide_stack)
    k1_40 = {
        "closest": cuda_ms(lambda: wide.wide_trace(*wide40, *p40, False,
                                                   *ws40), 20),
        "diffuse": cuda_ms(lambda: wide.wide_trace(*wide40, *d40, False,
                                                   *ws40), 20),
        "anyhit": cuda_ms(lambda: wide.wide_trace(*wide40, *nee40, True,
                                                  *ws40), 20),
        "anyhit diffuse": cuda_ms(lambda: wide.wide_trace(
            *wide40, *dshadow40, True, *ws40), 20),
    }
    # The twins' work on every ray of each wave (K2 and K3 walk each ray's
    # nodes in the twin's order, so the twin's counts are their own).
    k23_bound = {
        "K2 closest": bound(N40, 16, tables40, ops_of(k23_stats["closest"])),
        "K2 diffuse": bound(N40, 16, tables40, ops_of(diff_stats["closest"])),
        "K2 any-hit": bound(N40, 16, tables40, ops_of(k23_stats["anyhit"])),
        "K3": bound(N40, 4, tables40, ops_of(k23_stats["occluded"])),
        "K3 diffuse": bound(N40, 4, tables40, ops_of(diff_stats["occluded"])),
    }
    for name, (k_ms, p_ms) in k23_timing.items():
        b_ms, b_by = k23_bound[name]
        wave = {"K2 closest": "primary", "K2 diffuse": "diffuse",
                "K3 diffuse": "diffuse shadow"}.get(name, "NEE")
        print(f"{name} on the arch-40k {w40}x{h40} {wave} wave ({N40} "
              f"rays): kernel {k_ms:.4f} ms, plain torch {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    print(f"dispatch comparison on the same arch-40k waves: K1 closest-hit "
          f"{k1_40['closest']:.4f} ms vs K2 {k23_timing['K2 closest'][0]:.4f}"
          f" ms (primary), {k1_40['diffuse']:.4f} ms vs "
          f"{k23_timing['K2 diffuse'][0]:.4f} ms (diffuse); K1 any-hit "
          f"{k1_40['anyhit']:.4f} ms vs K3 {k23_timing['K3'][0]:.4f} ms "
          f"(NEE), K1 any-hit "
          f"{k1_40['anyhit diffuse']:.4f} ms vs K3 "
          f"{k23_timing['K3 diffuse'][0]:.4f} ms (diffuse shadow) ({smi})",
          flush=True)
    phase("K2/K3 timing", t0)

    # -- K1, K2 and K3 on non-finite rays ------------------------------------
    # The random-4k rays and 4,096 strided rays of the 1080p arch-260k
    # (K1) / 960x540 arch-40k (K2, K3) primary wave, with edge cases in
    # about one ray in eight of each component (nonfinite_rays). Each
    # kernel against its twin on every ray: K1 closest-hit and K2 (both
    # modes) t, u, v bits with NaN counted equal and tri; K1 any-hit and
    # K3 blocked bits; no ray at a step bound. Their slab tests take
    # NaN-returning min / max, as the twins' torch.minimum / maximum do.
    # A few of these rays walk far longer than any ray of a frame, and a
    # twin takes a step for all its rays until the longest ends: on 65,536
    # rays of the arch waves the twins took 60 s a call (NVIDIA H100 80GB
    # HBM3, 700 W), so the arch waves give 4,096.
    t0 = time.perf_counter()
    rows = ["| kernel | wave | rays (non-finite) | outputs equal | "
            "hit / blocked frac | kernel + twin s | verdict |",
            "|---|---|---|---|---|---|---|"]
    nf_ok, nf_equal = True, {}
    capped0 = wide.capped_rays(dev) + bvh2.capped_rays(dev)
    for kname, wname, bufs, base, seed in (
            ("K1", "random-4k", rscene, (ro, rd), 41),
            ("K1", "arch-260k primary 1080p, strided", arch, prim[:2], 42),
            ("K2/K3", "random-4k", rscene, (ro, rd), 43),
            ("K2/K3", "arch-40k primary 960x540, strided", arch40,
             prim40[:2], 44)):
        n = base[0].shape[0]
        idx = (torch.arange(n, device=dev) if bufs is rscene else
               torch.arange(0, n, max(n // 4096, 1), device=dev)[:4096])
        nro, nrd = (x.contiguous() for x in nonfinite_rays(
            *(b[idx] for b in base), seed))
        n = nro.shape[0]
        bad = int((~(torch.isfinite(nro).all(1)
                     & torch.isfinite(nrd).all(1))).sum())
        act = torch.ones(n, dtype=torch.bool, device=dev)
        far = torch.full((n,), 1e30, device=dev)
        near = torch.full((n,), 25.0, device=dev)
        if kname == "K1":
            tw = (bufs.trav_rows,)
            sz = (bufs.wide_end, bufs.wide_stack)
            calls = {"closest": (wide.wide_trace, wide.wide_trace_plain,
                                 (*tw, nro, nrd, far, act, False, *sz)),
                     "any-hit": (wide.wide_trace, wide.wide_trace_plain,
                                 (*tw, nro, nrd, near, act, True, *sz))}
        else:
            tb = (bufs.node_rows, bufs.leaf_rows)
            tr = (bufs.num_nodes, bufs.stack_depth)
            oc = (bufs.end_index, bufs.num_nodes)
            calls = {
                "K2 closest": (bvh2.bvh2_trace, bvh2.bvh2_trace_plain,
                               (*tb, nro, nrd, far, act, False, *tr)),
                "K2 any-hit": (bvh2.bvh2_trace, bvh2.bvh2_trace_plain,
                               (*tb, nro, nrd, near, act, True, *tr)),
                "K3": (bvh2.bvh2_occluded, bvh2.bvh2_occluded_plain,
                       (*tb, nro, nrd, near, act, *oc))}
        for mode, (kfn, pfn, args) in calls.items():
            t1 = time.perf_counter()
            k_out, p_out = kfn(*args), pfn(*args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            if not isinstance(k_out, tuple):
                k_out, p_out = (k_out,), (p_out,)
            same = all(nan_equal(a, b) if a.dtype == torch.float32
                       else bits_equal(a, b) for a, b in zip(k_out, p_out))
            # tri >= 0 (K1 closest-hit, K2 in both modes) or a blocked
            # bit (K1 any-hit, K3).
            hit = (k_out[-1] >= 0 if mode in ("closest", "K2 closest",
                                             "K2 any-hit")
                   else k_out[-1] > 0)
            frac = float(hit.float().mean())
            key = f"{kname.split('/')[0]} {mode}" if kname == "K1" else mode
            nf_equal[key] = nf_equal.get(key, True) and same
            nf_ok &= same
            rows.append(f"| {key} | {wname} | {n} ({bad}) | {same} | "
                        f"{frac:.4f} | {sec:.2f} | "
                        f"{'PASS' if same else 'FAIL'} |")
    nf_capped = wide.capped_rays(dev) + bvh2.capped_rays(dev) - capped0
    rows.append(f"rays stopped by a step bound (kernels and twins, all "
                f"waves): {nf_capped}")
    print("\n".join(rows), flush=True)
    phase("K1/K2/K3 on non-finite rays", t0)
    if not nf_ok or nf_capped:
        raise SystemExit("chip_smoke: a traversal kernel disagrees with its "
                         "plain version on non-finite rays, or rays reached "
                         "a step bound")

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

    # -- Tile-parallel frames: the headline frame over meshes of this card ---
    tile_frames, tile_launches = tiles_phase(lt, dev, arch, renderer, smi)

    # -- Scene content: textures, the probe, blue noise, spp batching --------
    # Three 1080p frames through the port's entry points, each timed over 5
    # warm frames (CUDA events) with K1's launches counted around it:
    # (a) the textured arch-260k hall with 200 props flattened into its BVH
    # (bench.py's section_textured) through Renderer, 1 spp; (b) the same
    # hall under a 1024x2048 HDR sky with a sun, blue noise on and
    # samples_per_frame=4 (8,294,400 slots a wave); (c) trace_paths on the
    # untextured arch-260k at spp=4 in one wave (section_spp) beside the
    # same call at 1 spp. K1 a frame: 3 closest-hit and 4 any-hit waves
    # (3 light NEE, the final gather), 3 more any-hit with a probe (env NEE).
    t0 = time.perf_counter()
    del renderer
    torch.cuda.empty_cache()
    scene_tex = lt.build_arch_scene(260_000, textured=True, props=200)
    stamps = [time.perf_counter()]
    tex260 = lt.build_scene_buffers(scene_tex)
    stamps.append(time.perf_counter())
    sky_probe = lt.build_probe(sky_equirect(1024, 2048))
    stamps.append(time.perf_counter())
    content260 = lt.build_scene_buffers(scene_tex, probe=sky_probe)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    noise_raw = lt.generate_blue_noise()
    stamps.append(time.perf_counter())
    sec = [b - a for a, b in zip([t0] + stamps, stamps)]
    print(f"textured arch-260k + 200 props: {scene_tex.stats()['triangles']}"
          f" triangles in {scene_tex.stats()['instances']} instances; "
          f"seconds: scene {sec[0]:.2f}, buffers {sec[1]:.2f}, build_probe "
          f"(1024x2048) {sec[2]:.2f}, buffers with the probe {sec[3]:.2f}, "
          f"generate_blue_noise {sec[4]:.2f}; BVH2 nodes {tex260.num_nodes},"
          f" wide rows {tex260.wide_end}; atlas {tuple(tex260.atlas.shape)} "
          f"({tex260.atlas.numel()} bytes), {tex260.atlas_blocks.shape[0]} "
          f"textures; probe {tuple(content260.probe.shape)}, sampling grid "
          f"{tuple(content260.probe_pdf.shape)}", flush=True)
    phase("content scene build", t0)

    frames = dict(tile_frames)

    def content_frame(name, bufs, cfg, noise=None):
        """Renderer frames of one configuration: a warm-up frame, then 5
        timed; checks K1's launches a frame and the image."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = lt.Renderer((WIDTH, HEIGHT), cfg)
        r.set_resources(bufs)
        if noise is not None:
            r.upload_noise_texture(noise)
            r.use_noise_texture(True)
        r.accumulate = True
        view = lt.arch_camera()
        wide.reset_counters()
        bvh2.reset_counters()
        r.raytrace(view)  # warm-up frame; accum == its sample
        first = r.accum.clone()
        ms = event_ms(lambda: r.raytrace(view), 5)
        img = r.blit()
        nf = 6
        got = {"closest": wide.launches_closest / nf,
               "anyhit": wide.launches_anyhit / nf}
        want = {"closest": BOUNCES,
                "anyhit": BOUNCES + 1 + (BOUNCES if bufs.has_probe else 0)}
        capped = wide.capped_rays(dev) + bvh2.capped_rays(dev)
        spp = cfg.samples_per_frame
        record_frame(name, ms, first.reshape(-1, 3), got, want, capped, spp,
                     bvh2.launches_closest + bvh2.launches_occluded, img,
                     r.accum)
        return r

    def record_frame(name, ms, sample, got, want, capped, spp, k23, img,
                     accum):
        mean = float(np.mean(ms))
        nonzero = float((sample.sum(1) > 0).float().mean())
        peak = torch.cuda.max_memory_allocated() / 2**30
        rays = WIDTH * HEIGHT * BOUNCES * 2 * spp
        frames[name] = {"ms_mean": mean, "ms_min": min(ms), "ms": ms,
                        "mrays_s": rays / mean / 1e3, "spp": spp,
                        "k1_launches_per_frame": got,
                        "nonzero_pixel_frac": nonzero, "peak_gib": peak}
        print(f"{name} frame: ms (CUDA events) mean {mean:.3f}, min "
              f"{min(ms):.3f}, all {[round(x, 3) for x in ms]}; Mrays/s "
              f"{rays / mean / 1e3:.3f} (pixels x bounces x 2 x spp {spp}); "
              f"K1 launches a frame {got} (want {want}); K2/K3 launches "
              f"{k23}; nonzero_pixel_frac {nonzero:.4f}; peak memory "
              f"{peak:.2f} GiB; rays stopped by a step bound {capped} "
              f"({smi})", flush=True)
        if got != want or k23:
            raise SystemExit(f"chip_smoke: the {name} frame launched K1 "
                             f"{got} times a frame, not {want}, or K2/K3")
        if capped:
            raise SystemExit("chip_smoke: rays reached the step bound")
        if not (torch.isfinite(accum).all() and
                (img is None or (img.shape == (HEIGHT, WIDTH, 3)
                                 and img.dtype == np.uint8))):
            raise SystemExit(f"chip_smoke: non-finite or misshapen {name} "
                             f"frame")
        if nonzero < 0.5:
            raise SystemExit(f"chip_smoke: the {name} frame is mostly black")

    t0 = time.perf_counter()
    base_cfg = lt.RenderConfig(downsample_factor=1.0, denoise=False)
    content_frame("textured", tex260, base_cfg)
    phase("textured frame (a): warm-up + 5 frames + blit", t0)
    t0 = time.perf_counter()
    r_b = content_frame("content", content260,
                        dataclasses.replace(base_cfg, samples_per_frame=4),
                        noise=noise_raw)
    phase("content frame (b): warm-up + 5 frames + blit", t0)

    # K1 against its twin on frame (b)'s own waves, recorded from one more
    # frame of its renderer (after its launches were read): the textured
    # hall's BVH at 8,294,400 slots. A frame's K1 calls, in order:
    # closest-hit, bounces 0-2; any-hit, light NEE and env NEE at each
    # bounce, then the final gather. Exact, as phase 3.
    t0 = time.perf_counter()
    rec = k1_waves(lambda: r_b.raytrace(lt.arch_camera()),
                   {("closest", 0): "primary", ("anyhit", 1): "env",
                    ("closest", 1): "bounce1", ("anyhit", 6): "gather"})
    del r_b
    torch.cuda.empty_cache()
    rows = ["| wave | rays compared | tri equal | t max ulp | blocked equal "
            "| hit / blocked frac | hits won by the copy | verdict |",
            "|---|---|---|---|---|---|---|---|"]
    ok = all(bool((rec[w][2] == 1e30).all()) for w in ("primary", "bounce1"))
    rows.append(f"closest-hit waves traced to T_FAR: {ok}")
    capped0 = wide.capped_rays(dev)
    for wname, closest, shadow in (
            ("content frame (b) / primary, 4 spp (shadow: bounce 0's env "
             "NEE, tmax from scene_exit_t, self-sorted)", "primary", "env"),
            ("content frame (b) / bounce 1, sorted (shadow: the final "
             "gather)", "bounce1", "gather")):
        ro_, rd_, _, act_ = rec[closest]
        ok_w, t_e, b_e = compare_wide(wname, content260, (ro_, rd_, act_),
                                      rec[shadow], rows)
        ok &= ok_w
        k1_err[0], k1_err[1] = max(k1_err[0], t_e), max(k1_err[1], b_e)
    del rec
    capped = wide.capped_rays(dev) - capped0
    rows.append(f"rays stopped by the step bound (kernel and twin, these "
                f"waves): {capped}")
    print("\n".join(rows), flush=True)
    phase("K1 on frame (b)'s waves", t0)
    if not ok or capped:
        raise SystemExit("chip_smoke: K1 disagrees with its plain version "
                         "on frame (b)'s waves, or rays reached the step "
                         "bound")

    # (c): trace_paths on the headline scene, 1 spp then spp=4, one call.
    t0 = time.perf_counter()
    g_spp = torch.Generator(device=dev)
    g_spp.manual_seed(13)
    for name, spp in (("headline 1 spp (trace_paths)", 1),
                      ("spp 4 (trace_paths)", 4)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wide.reset_counters()
        bvh2.reset_counters()
        sample = trace_paths(arch, cam, WIDTH, HEIGHT, g_spp,
                             bounces=BOUNCES, spp=spp)[0]
        ms = event_ms(lambda: trace_paths(arch, cam, WIDTH, HEIGHT, g_spp,
                                          bounces=BOUNCES, spp=spp), 5)
        got = {"closest": wide.launches_closest / 6,
               "anyhit": wide.launches_anyhit / 6}
        record_frame(name, ms, sample, got,
                     {"closest": BOUNCES, "anyhit": BOUNCES + 1},
                     wide.capped_rays(dev) + bvh2.capped_rays(dev), spp,
                     bvh2.launches_closest + bvh2.launches_occluded, None,
                     sample)
    phase("spp frame (c) beside the 1-spp frame: 6 + 6 calls", t0)

    # spp=2 in one wave equals the mean of its two 1-spp frames under blue
    # noise (sample s at frame fc * 2 + s), on the textured 1080p hall with
    # the inter-bounce sort off and on (the hall is past its node gate).
    t0 = time.perf_counter()
    noise_tex = torch.from_numpy((noise_raw[..., :2].astype(np.float32)
                                  + 0.5) / 256.0).to(dev)
    fc = 3
    for sort in (False, True):
        kw = dict(bounces=BOUNCES, sort_rays=sort, noise_tex=noise_tex)
        batched = trace_paths(tex260, cam, WIDTH, HEIGHT, g_spp,
                              frame_count=fc, spp=2, **kw)[0]
        singles = [trace_paths(
            tex260, cam, WIDTH, HEIGHT, g_spp, frame_count=fc * 2 + s,
            jitter=rmod.blue_noise_uv(noise_tex, fc * 2 + s, WIDTH, HEIGHT,
                                      dim=0),
            nee_uv=rmod.blue_noise_uv(noise_tex, fc * 2 + s, WIDTH, HEIGHT,
                                      dim=1), **kw)[0] for s in range(2)]
        want = (singles[0] + singles[1]) / 2
        same = bool(torch.allclose(batched, want, rtol=1e-5, atol=1e-6))
        err = float((batched - want).abs().max())
        print(f"spp=2 in one wave vs the mean of its two 1-spp frames, blue "
              f"noise, sort {'on' if sort else 'off'}: allclose (rtol 1e-5, "
              f"atol 1e-6) {same}, max |diff| {err:.3e}, mean "
              f"{float(want.mean()):.5f}")
        if not same or float(want.mean()) < 1e-3:
            raise SystemExit("chip_smoke: spp=2 in one wave differs from "
                             "the mean of its single frames")
    phase("spp=2 identity, sort off and on", t0)

    # Small frames: the card against the plain CPU path, the same explicit
    # uniforms: the textured quad (K2/K3 on a 2-triangle scene) and a
    # textured arch-20k hall with 20 props under a sky, with blue noise.
    t0 = time.perf_counter()
    small_probe = lt.build_probe(sky_equirect(64, 128))
    for name, scene, probe, view, noise in (
            ("textured quad 64x64", textured_quad_scene(), None, TEX_CAM,
             False),
            ("textured arch-20k + 20 props, sky, blue noise 128x64",
             lt.build_arch_scene(20_000, textured=True, props=20),
             small_probe, lt.arch_camera(), True)):
        sw, sh = (64, 64) if probe is None else (128, 64)
        bufs = lt.build_scene_buffers(scene, probe=probe)
        bufs_cpu = bufs.to("cpu")
        gu.manual_seed(9)
        uni = draw_uniforms(sw * sh, BOUNCES, gu, "cpu", env=bufs.has_probe)
        v = torch.from_numpy(view)
        outs = []
        for b, u, d in ((bufs_cpu, uni, "cpu"), (bufs, uni.to(dev), dev)):
            kw = {}
            if noise:
                nt = noise_tex.to(d)
                kw = dict(noise_tex=nt, frame_count=fc,
                          jitter=rmod.blue_noise_uv(nt, fc, sw, sh, dim=0),
                          nee_uv=rmod.blue_noise_uv(nt, fc, sw, sh, dim=1))
            outs.append(trace_paths(b, v.to(d), sw, sh, bounces=BOUNCES,
                                    sort_rays=False, uniforms=u,
                                    **kw)[0].cpu())
        ref, out = outs
        close = float(torch.isclose(out, ref, rtol=1e-4, atol=1e-5).all(1)
                      .float().mean())
        rel = abs(float(out.mean()) / max(float(ref.mean()), 1e-12) - 1.0)
        print(f"small frame {name}: card vs CPU plain path (BVH2 nodes "
              f"{bufs.num_nodes}: K2/K3), pixels close {close:.5f}, mean rel "
              f"diff {rel:.2e}, mean {float(ref.mean()):.5f}")
        if close < 0.995 or rel > 1e-3 or not float(ref.mean()) > 0:
            raise SystemExit(f"chip_smoke: the card's {name} frame "
                             f"disagrees with the CPU path")
    del tex260, content260
    phase("content small frames vs CPU", t0)

    # -- Two-level instancing: the 1080p instanced frame ---------------------
    inst_res = instanced_phase(lt, dev, smi, frames, gu)

    # -- The interactive path: the app's default frame -----------------------
    t0 = time.perf_counter()
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

    # K2's and K3's device time in one interactive frame (torch.profiler):
    # the sum over the frame's launches (K2: its closest-hit waves; K3: its
    # NEE and final-gather shadow waves). `frame_launches`: the launches of
    # the last frame, the one the profiler's step reads.
    frame_launches = {}

    def next_frame():
        view[0, 3] += 1e-3
        k2, k3 = bvh2.launches_closest, bvh2.launches_occluded
        inter.raytrace(view)
        frame_launches["K2"] = bvh2.launches_closest - k2
        frame_launches["K3"] = bvh2.launches_occluded - k3

    def frame_complete(ks):
        return all(sum(w in n for n, _ in ks) == frame_launches[k]
                   for k, w in (("K2", "bvh2_trace_kernel"),
                                ("K3", "bvh2_occluded_kernel")))

    cap0 = bvh2.capped_rays(dev)
    frame_kernels = device_kernels(next_frame, frame_complete)
    k2_frame = [ms for name, ms in frame_kernels
                if "bvh2_trace_kernel" in name]
    k3_frame = [ms for name, ms in frame_kernels
                if "bvh2_occluded_kernel" in name]
    n_k2, n_k3 = frame_launches["K2"], frame_launches["K3"]
    frame_capped = bvh2.capped_rays(dev) - cap0
    k2_frame_ms, k3_frame_ms = sum(k2_frame), sum(k3_frame)
    for kname, n_k, got, total in (("K2", n_k2, k2_frame, k2_frame_ms),
                                   ("K3", n_k3, k3_frame, k3_frame_ms)):
        print(f"{kname} in one interactive frame (torch.profiler): {n_k} "
              f"launches, {len(got)} kernels recorded, "
              f"{[round(x, 4) for x in got]} ms, sum {total:.4f} ms ({smi})",
              flush=True)
        if n_k == 0 or len(got) != n_k:
            raise SystemExit(f"chip_smoke: the profiler did not record each "
                             f"{kname} launch of the interactive frame")
    print(f"rays stopped by the step bound in the profiled frames (K2 and "
          f"K3): {frame_capped}")
    if frame_capped:
        raise SystemExit("chip_smoke: a K2 or K3 launch of the interactive "
                         "frame stopped rays at the step bound")

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

    # -- The treelet path ------------------------------------------------------
    # Its tables on the same arch-260k scene (the native builder gives the
    # same tree; every comparison below runs on this one buffer set).
    t0 = time.perf_counter()
    del inter
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    archT = lt.build_scene_buffers(scene_cpu, treelets=True)
    torch.cuda.synchronize()
    tb_s = time.perf_counter() - t1
    td = archT.treelet
    S = td.num_subtrees
    top_bytes = td.top_fields.numel() * 4
    sub_bytes = td.sub_fields.numel() * 4
    print(f"arch-260k with treelets=True: buffers {tb_s:.2f} s (without "
          f"{build_s:.2f} s, so the treelet host build ~{tb_s - build_s:.2f} "
          f"s); {archT.stats()}; top table {top_bytes} bytes, subtree "
          f"tables {sub_bytes} bytes ({S} + 1 dump tile); same tree as the "
          f"headline's: {bits_equal(archT.trav_rows, arch.trav_rows)}")
    phase("treelet scene build", t0)

    # K4 against its twin on three inputs; the primary wave's pairs first.
    t0 = time.perf_counter()
    pro, prd, pact = prim
    key, ray_of, _ = lane_top.lane_top_pairs(td.top_fields, pro, prd, tfar,
                                             pact, td.num_top, S)
    # The plan and cluster shape of each input below, before its first
    # launch.
    for c, npay in ((16, 1), (16, 3), (20, 2), (20, 3), (20, 4), (22, 0),
                    (23, 1)):
        span, b = ss._shape(c, npay)
        print(f"K4 at c_log {c}, {npay} payload: plan "
              f"{ss.launch_plan(c, npay)}; clusters of {1 << (span - b)} "
              f"blocks of 2^{b} keys ({(1 + npay) * 4 << b} bytes of shared "
              f"memory each), 2^{span} keys a cluster; "
              f"cudaOccupancyMaxActiveClusters "
              f"{ss.max_active_clusters(c, npay)}")
    print("K4 ptxas (registers, shared memory, spills):\n" + "\n".join(
        line for line in _build.build_info["slab_sort"]["log"].splitlines()
        if "entry function" in line or "Used" in line or "spill" in line))
    rows = ["| input | keys | repeats | matrix equal | unpacked equal | "
            "slabs sorted | CUDA launches made | verdict |",
            "|---|---|---|---|---|---|---|---|"]
    ok, k4_err, k4_mat, c_log = compare_slab_sort(
        "arch-260k primary 1080p (subtree, ray) pairs", key, [ray_of], rows)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    nr = 1_000_003
    cols = [torch.randint(-2**31, 2**31 - 1, (nr,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.rand(nr, generator=g, device=dev),
            torch.rand(nr, generator=g, device=dev) < 0.5]
    ok &= compare_slab_sort(
        "random int32 keys, payload int32 + float32 + bool",
        torch.randint(-2**31, 2**31 - 1, (nr,), generator=g, device=dev,
                      dtype=torch.int32), cols, rows)[0]
    nu = 600_001
    ukey = torch.randint(0, 2**32, (nu,), generator=g, device=dev,
                         dtype=torch.int64)
    ukey[torch.rand(nu, generator=g, device=dev) < 0.3] = DEAD_KEY
    ok &= compare_slab_sort("uint32 keys (int64) with 30% DEAD_KEY", ukey,
                            [torch.arange(nu, device=dev, dtype=torch.int32)],
                            rows)[0]
    # Above the span: global passes with two, three and four payload rows
    # (clusters of 2^17 and 2^16 keys), and with none (2^18).
    nb = 1 << 20
    for npay in (2, 3, 4):
        ok &= compare_slab_sort(
            f"random keys in [0, 1000) above the span, payload int32 x "
            f"{npay}",
            torch.randint(0, 1000, (nb,), generator=g, device=dev,
                          dtype=torch.int32),
            [torch.arange(nb, device=dev, dtype=torch.int32)] + [
                torch.randint(-2**31, 2**31 - 1, (nb,), generator=g,
                              device=dev, dtype=torch.int32)
                for _ in range(npay - 1)], rows, slab_log=20)[0]
    nk = 1 << 22
    ok &= compare_slab_sort(
        "random int32 keys above the span, keys only",
        torch.randint(-2**31, 2**31 - 1, (nk,), generator=g, device=dev,
                      dtype=torch.int32), [], rows, slab_log=22)[0]
    print("\n".join(rows), flush=True)
    if not ok:
        raise SystemExit("chip_smoke: K4 disagrees with its plain version")
    work = torch.empty_like(k4_mat)
    copy_ms = cuda_ms(lambda: work.copy_(k4_mat), 20)
    k4_ms = cuda_ms(lambda: ss.sort_matrix(work.copy_(k4_mat), c_log),
                    20) - copy_ms
    k4_plain = cuda_ms(lambda: ss.slab_sort_plain(work.copy_(k4_mat), c_log),
                       1, warm=False) - copy_ms
    n_slabs = k4_mat.shape[1] >> c_log

    def k4_library():
        v, i = torch.sort(k4_mat[0].view(n_slabs, -1), dim=1)
        return v, torch.gather(k4_mat[1].view(n_slabs, -1), 1, i)

    k4_lib = cuda_ms(k4_library, 20)
    # Operations: per compare-exchange one compare and two selects per row.
    k4_cx = c_log * (c_log + 1) // 2 * (k4_mat.shape[1] // 2)
    k4_bound = bound_of(2 * k4_mat.numel() * 4,
                        k4_cx * (1 + 2 * k4_mat.shape[0]))
    print(f"K4 on the primary wave's {key.shape[0]} pair keys ({n_slabs} "
          f"slabs of 2^{c_log}, 1 payload; {ss.cuda_launches(c_log, 1)} "
          f"CUDA launches a sort): kernel {k4_ms:.4f} ms, plain torch "
          f"{k4_plain:.3f} ms, torch.sort + gather along the slab rows "
          f"{k4_lib:.4f} ms (ties in any order); bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}: {2 * k4_mat.numel() * 4} bytes, {k4_cx} "
          f"compare-exchanges); matrix copy {copy_ms:.4f} ms subtracted "
          f"({smi})", flush=True)
    phase("K4: seven inputs + timing", t0)

    # E5, both entries, on the (subtree, ray) pairs of the primary and the
    # sorted diffuse wave, three kernel runs each: the path's entry
    # (regroup_blocks: K4's sorted matrix to block_regroup's layout)
    # against its plain version (block_runs + scatter_runs_plain +
    # block_layout) and the grouped (key, ray) multiset; the run-list entry
    # (scatter_runs) against scatter_runs_plain.
    t0 = time.perf_counter()
    dkey, dray_of, _ = lane_top.lane_top_pairs(td.top_fields, diff260[0],
                                               diff260[1], tfar, diff260[2],
                                               td.num_top, S)
    e5_err = {"blocks": 0.0, "runs": 0.0}
    e5_timing, e5_rows, e5_ok = {}, [], True
    for wname, (wkey, wray) in (("primary", (key, ray_of)),
                                ("diffuse, sorted", (dkey, dray_of))):
        P = wkey.shape[0]
        mat5, c5 = regroup.sort_pairs(wkey, wray)
        want = regroup.regroup_blocks_plain(mat5, c5, P, S)
        got = [regroup.regroup_blocks(mat5, c5, P, S) for _ in range(3)]
        runs_args, (starts, counts) = regroup.block_runs(mat5, c5, P, S)
        want_r = regroup.scatter_runs_plain(*runs_args)
        got_r = [regroup.scatter_runs(*runs_args) for _ in range(3)]
        torch.cuda.synchronize()
        same = [all(bits_equal(x, y) for x, y in zip(o, want)) for o in got]
        same_r = [bits_equal(o, want_r) for o in got_r]
        grouped = pair_multiset_equal(wkey, wray, S, *want, N)
        e5_err["blocks"] = max(e5_err["blocks"], max(
            float((x - y).abs().max()) for o in got for x, y in zip(o, want)))
        e5_err["runs"] = max(e5_err["runs"], max(
            float((o - want_r).abs().max()) for o in got_r))
        e5_ok &= all(same) and all(same_r) and grouped
        t = {"blocks": cuda_ms(lambda: regroup.regroup_blocks(mat5, c5, P, S),
                               20),
             "runs": cuda_ms(lambda: regroup.scatter_runs(*runs_args), 20),
             # The parent's binning: the torch glue, the run-list kernel and
             # the block layout.
             "chain": cuda_ms(lambda: regroup.block_layout(
                 regroup.scatter_runs(*regroup.block_runs(
                     mat5, c5, P, S)[0]), starts, counts, P), 10)}
        if wname == "primary":
            t["blocks_plain"] = cuda_ms(lambda: regroup.regroup_blocks_plain(
                mat5, c5, P, S), 1)
            t["runs_plain"] = cuda_ms(lambda: regroup.scatter_runs_plain(
                *runs_args), 1)
            t["by_launch"] = [(kernel_name(n), ms)
                              for n, ms in device_kernels(
                                  lambda: regroup.regroup_blocks(mat5, c5, P,
                                                                 S))]
            pray, sid, on = got[0]
            e5_args, e5_live = runs_args, int(counts.sum())
        e5_timing[wname] = t
        e5_rows.append(
            f"E5 on the {wname} wave's pairs ({int(counts.sum())} live of "
            f"{P}, {mat5.shape[1] >> c5} slabs, {S} keys, out_rows "
            f"{want[0].numel()}): regroup_blocks, three runs bit-equal to "
            f"its plain version {same}, grouped (key, ray) multiset equal "
            f"{grouped}; scatter_runs, three runs bit-equal to "
            f"scatter_runs_plain {same_r}; regroup_blocks {t['blocks']:.4f} "
            f"ms, scatter_runs {t['runs']:.4f} ms (with the zero fill), the "
            f"parent's binning (block_runs + scatter_runs + block_layout) "
            f"{t['chain']:.4f} ms")
    print("\n".join(e5_rows), flush=True)
    if not e5_ok:
        raise SystemExit("chip_smoke: E5 disagrees with its plain version")
    # Bytes the path entry must move: the live pairs' rays read once (not
    # the dump key's rays nor the padding; the keys' runs are found by
    # binary searches, a few words a (slab, key)), ray_out and on written
    # over every output slot, sid_blocks once. The run-list entry: the
    # copied pairs read once, the whole output written once, nruns and the
    # three run-table entries of each live run.
    e5_bound = {
        "blocks": bound_of((e5_live + 2 * pray.numel() + sid.numel()) * 4,
                           0),
        "runs": bound_of((e5_live + e5_args[5] + e5_args[1].numel()
                          + 3 * int(e5_args[1].sum())) * 4, 0)}
    t = e5_timing["primary"]
    print(f"E5 regroup_blocks on the primary wave: {t['blocks']:.4f} ms "
          f"(three launches: {[(n, round(ms, 4)) for n, ms in t['by_launch']]}"
          f" ms, torch.profiler), plain torch {t['blocks_plain']:.3f} ms, "
          f"bound {e5_bound['blocks'][0]:.4f} ms ({e5_bound['blocks'][1]}); "
          f"scatter_runs {t['runs']:.4f} ms, plain torch "
          f"{t['runs_plain']:.3f} ms, bound {e5_bound['runs'][0]:.4f} ms "
          f"({e5_bound['runs'][1]})")
    print("E5 ptxas (registers, stack frame, spills):\n"
          + ptxas_lines("regroup"))
    # block_regroup on the card under torch.profiler: the packing of the
    # pairs, K4's launch, then E5's three and nothing else, so no torch
    # searchsorted, repeat_interleave, gather or scatter kernel runs
    # between K4 and E7.
    def br_complete(ks):
        return (any("cluster_kernel" in n or "global_kernel" in n
                    for n, _ in ks)
                and all(any(w in n for n, _ in ks) for w in (
                    "runs_kernel", "layout_kernel", "place_kernel")))

    br_kernels = [n for n, _ in device_kernels(
        lambda: regroup.block_regroup(key, ray_of, S), br_complete)]
    print(f"block_regroup on the card (torch.profiler): {len(br_kernels)} "
          f"device kernels {br_kernels}")
    k4_at = [i for i, n in enumerate(br_kernels)
             if "cluster_kernel" in n or "global_kernel" in n]
    after = br_kernels[k4_at[0]:] if k4_at else []
    e5_names = ("runs_kernel", "layout_kernel", "place_kernel")
    glue = [n for n in after if not any(
        w in n for w in ("cluster_kernel", "global_kernel") + e5_names)]
    glue += [n for n in br_kernels if any(
        w in n.lower() for w in ("searchsorted", "repeat_interleave",
                                 "gather", "scatter", "index"))]
    if (not k4_at or glue
            or [sum(w in n for n in after) for w in e5_names] != [1, 1, 1]):
        raise SystemExit(f"chip_smoke: block_regroup ran torch glue {glue} "
                         f"after K4, or not E5's three launches once each")
    print(smi, flush=True)
    phase("E5: check + timing", t0)

    # E6 and E7 against their twins on two waves, then their times at the
    # primary wave's full shapes.
    t0 = time.perf_counter()
    rows = ["| wave | rays compared | E6 pend, npend equal | npend == 8 | "
            "mean npend | live pairs | E7 closest: t max ulp / tri equal / "
            "hits | E7 any-hit: same | verdict |",
            "|---|---|---|---|---|---|---|---|---|"]
    ok, lane_err = compare_lanes("arch-260k primary 1080p", td, prim, rows)
    ok &= compare_lanes("arch-260k diffuse 1080p, sorted", td, diff260,
                        rows)[0]
    capped = lane_top.capped_rays(dev) + lane_bottom.capped_pairs(dev)
    rows.append(f"lanes stopped by a step bound (E6, E7 and their twins, "
                f"both waves): {capped}")
    print("\n".join(rows), flush=True)
    if not ok or capped:
        raise SystemExit("chip_smoke: E6 or E7 disagrees with its plain "
                         "version, or lanes reached a step bound")
    # E6 at full shape, both epilogues, on every ray and pair slot of both
    # waves: three kernel runs each against one run of the plain version
    # (the compacting epilogue's scan crosses blocks); the plain walk on the
    # primary wave also counts the work its data needs (for the bounds).
    e6_stats, e6_timing, full_rows = {}, {}, []
    lane_err["E6 pairs"] = 0.0
    e6_waves = (("primary", (pro, prd, tfar, pact)),
                ("diffuse, sorted", (diff260[0], diff260[1], tfar,
                                     diff260[2])))
    for wname, wave in e6_waves:
        e6_args = (td.top_fields, *wave, td.num_top)
        st = e6_stats if wname == "primary" else None
        p_ms, (pp, npp) = timed(lambda: lane_top.lane_top_plain(
            *e6_args, stats=st), 1, warm=False)
        c_ms, want = timed(lambda: lane_top.compact_pairs(
            pp, npp, wave[3], S=S), 5)
        k_ms, out = timed(lambda: lane_top.lane_top_trace(*e6_args), 20)
        kc_ms, outc = timed(lambda: lane_top.lane_top_pairs(*e6_args, S), 20)
        runs = [out, lane_top.lane_top_trace(*e6_args),
                lane_top.lane_top_trace(*e6_args)]
        runs_c = [outc, lane_top.lane_top_pairs(*e6_args, S),
                  lane_top.lane_top_pairs(*e6_args, S)]
        torch.cuda.synchronize()
        same = [all(bits_equal(x, y) for x, y in zip(o, (pp, npp)))
                for o in runs]
        same_c = [all(bits_equal(x, y) for x, y in zip(o, want))
                  for o in runs_c]
        lane_err["E6"] = max(lane_err["E6"], max(float(max(
            (o[0] - pp).abs().max(), (o[1] - npp).abs().max())) for o in runs))
        lane_err["E6 pairs"] = max(lane_err["E6 pairs"], max(float(max(
            (o[0] - want[0]).abs().max(), (o[1] - want[1]).abs().max(),
            (o[2].int() - want[2].int()).abs().max())) for o in runs_c))
        ok &= all(same) and all(same_c)
        n_pairs = int((want[0] < S).sum())
        n_fb = int(want[2].sum())
        e6_timing[wname] = {"per_ray": k_ms, "pairs": kc_ms, "plain": p_ms,
                            "compact_pairs": c_ms}
        full_rows.append(
            f"E6 on all {N} rays of the {wname} wave: per ray, pend and npend "
            f"of three kernel runs bit-equal to the plain version {same}; "
            f"compacting, key and ray_of of all {want[0].numel()} pair slots "
            f"and the {N} fallback flags of three runs bit-equal to "
            f"lane_top_plain + compact_pairs {same_c} ({n_pairs} pairs, "
            f"{n_fb} fallback rays, npend == 8: "
            f"{int((npp == 8).sum())}); kernel per ray {k_ms:.4f} ms, "
            f"compacting {kc_ms:.4f} ms; plain walk {p_ms:.3f} ms, "
            f"compact_pairs alone {c_ms:.4f} ms")
    # E7 at the primary wave's full shapes, both epilogues and modes: the
    # kernel three times (its atomics land in a different order each
    # time) against one run of the plain version, which also counts the
    # work this wave's data needs (for the bounds).
    pr = pray.long()
    e7_pair = (sid, td.sub_fields, pro[pr].contiguous(), prd[pr].contiguous(),
               tfar[pr].contiguous(), on)
    e7_ray = (sid, td.sub_fields, td.sub_tri_base, pray, on, pro, prd, tfar)
    live_pairs = int((on > 0).sum())
    P = on.shape[0]
    # The pairs the kernel walks: live, in a tile of a real subtree.
    walked = (on > 0) & (sid.repeat_interleave(P // sid.numel()) < S)
    walked_pairs = int(walked.sum())
    rays_paired = int(torch.unique(pray[walked]).numel())
    e7_timing, e7_stats = {}, {}
    for epi in ("per ray", "per pair"):
        for mode in ("closest", "anyhit"):
            any_hit = mode == "anyhit"
            if epi == "per ray":
                def kfn(a=any_hit):
                    return (lane_bottom.lane_bottom_rays(*e7_ray, a),)

                def pfn(a=any_hit, st=e7_stats.setdefault(mode, {})):
                    return (lane_bottom.lane_bottom_rays_plain(
                        *e7_ray, a, stats=st),)
            else:
                def kfn(a=any_hit):
                    return lane_bottom.lane_bottom_trace(*e7_pair, a)

                def pfn(a=any_hit):
                    return lane_bottom.lane_bottom_plain(*e7_pair, a)
            k_ms, out = timed(kfn, 10)
            p_ms, want = timed(pfn, 1, warm=False)
            runs = [out, kfn(), kfn()]
            torch.cuda.synchronize()
            same = [all(bits_equal(x, y) for x, y in zip(o, want))
                    for o in runs]
            if epi == "per ray":
                kt = lane_bottom.unpack_hits(out[0], tfar)[0]
                pt = lane_bottom.unpack_hits(want[0], tfar)[0]
            else:
                kt, pt = out[0], want[0]
            err = float((kt - pt).abs().max())
            lane_err[(epi, mode)] = err
            e7_timing[(epi, mode)] = (k_ms, p_ms)
            ok &= all(same)
            full_rows.append(
                f"E7 {epi} {mode} on all {P} pair slots of the primary wave "
                f"({live_pairs} live pairs, {walked_pairs} walked, of "
                f"{rays_paired} rays): three "
                f"kernel runs bit-equal to the plain version {same}; max "
                f"|t| error {err}")
    capped = lane_top.capped_rays(dev) + lane_bottom.capped_pairs(dev)
    full_rows.append(f"lanes stopped by a step bound (with the full-shape "
                     f"runs): {capped}")
    print("\n".join(full_rows), flush=True)
    if not ok or capped:
        raise SystemExit("chip_smoke: E6 or E7 disagrees with its plain "
                         "version at the path's shapes, or lanes reached a "
                         "step bound")
    # E6 reads the active flag of every ray, ro, rd and tmax of the active
    # ones and the top table once (its blocks' re-reads of the table are the
    # design's, served from L2); per ray it writes 32 bytes of ids and npend
    # a ray, compacting 8 bytes a pair slot (key, ray_of) and the fallback
    # flag a ray.
    n_act = int(pact.sum())
    e6_in = N + n_act * (RAY_IN_BYTES - 1) + top_bytes
    e6_bound = {
        "per_ray": bound_of(e6_in + N * 36,
                            e6_stats["box_tests"] * OPS_BOX),
        "pairs": bound_of(e6_in + lane_top.PAIR_BUDGET * N * 8 + N,
                          e6_stats["box_tests"] * OPS_BOX)}
    # E7 per pair reads tmax and the active flag of every slot and ro, rd
    # only for walked pairs, and writes t and tri of every slot. Per ray it
    # reads the active flag of every slot, pair_ray of each walked pair,
    # ro, rd, t0 of each ray with a walked pair once and the triangle
    # bases, and writes one 8-byte word a ray. Both read the subtree
    # table's 10 walked fields.
    walk_bytes = sid.numel() * 4 + sub_bytes * 10 // 11
    e7_bytes = {"per pair": P * 16 + walked_pairs * 24 + walk_bytes,
                "per ray": P * 4 + walked_pairs * 4 + rays_paired * 28
                + (S + 1) * 4 + N * 8 + walk_bytes}
    e7_bound = {k: bound_of(e7_bytes[k[0]],
                            ops_of(e7_stats[k[1]], box_key="box_tests"))
                for k in e7_timing}
    et = e6_timing["primary"]
    for epi in ("per_ray", "pairs"):
        print(f"E6 {epi} on the 1080p primary wave ({N} rays, K "
              f"{td.num_top}): kernel {et[epi]:.4f} ms, bound "
              f"{e6_bound[epi][0]:.4f} ms ({e6_bound[epi][1]}; twin work "
              f"on the wave: {e6_stats})")
    print(f"E6 per ray, then compact_pairs in torch: "
          f"{et['per_ray'] + et['compact_pairs']:.4f} ms, against the "
          f"compacting epilogue's {et['pairs']:.4f} ms")
    print("E6/E7 ptxas (registers, stack frame, spills):\n" + "\n".join(
        line for line in _build.build_info["treelet_traverse"]["log"]
        .splitlines() if "Used" in line or "stack frame" in line))
    for (epi, m), (k_ms, p_ms) in e7_timing.items():
        b_ms, b_by = e7_bound[(epi, m)]
        print(f"E7 {epi} {m} on the primary wave's pairs ({P} slots, "
              f"{walked_pairs} walked, {P // 1024} tiles): kernel "
              f"{k_ms:.4f} ms, "
              f"plain torch {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{e7_bytes[epi]} bytes; twin work on the wave's pairs: "
              f"{e7_stats[m]})")
    print(smi, flush=True)
    phase("E6/E7: two waves + timing", t0)

    # E6 and E7 on rays with non-finite components: their slab tests take
    # NaN-returning min / max, as the twins' torch.minimum / maximum do.
    t0 = time.perf_counter()
    rows = ["| kernel | rays (non-finite) | 3 runs equal | compacting: 3 "
            "runs equal | share with a pending subtree | verdict |",
            "|---|---|---|---|---|---|"]
    capped0 = lane_top.capped_rays(dev) + lane_bottom.capped_pairs(dev)
    lanes_nf = compare_lanes_nonfinite(td, prim, S, 45, rows)
    lanes_nf_capped = (lane_top.capped_rays(dev)
                       + lane_bottom.capped_pairs(dev) - capped0)
    rows.append(f"lanes stopped by a step bound (kernels and twins): "
                f"{lanes_nf_capped}")
    print("\n".join(rows), flush=True)
    phase("E6/E7 on non-finite rays", t0)
    if not all(lanes_nf) or lanes_nf_capped:
        raise SystemExit("chip_smoke: E6 or E7 disagrees with its plain "
                         "version on non-finite rays, or lanes reached a "
                         "step bound")

    # The pipeline against K1 on the same full waves; one wave's time by
    # stage against K1's.
    t0 = time.perf_counter()
    rows = ["| wave | rays | tri agree (ties) | t max ulp | fallback rays "
            "(share) | verdict |", "|---|---|---|---|---|---|"]
    ok = True
    for name, (wro, wrd, wact) in (("primary 1080p", prim),
                                   ("diffuse 1080p, sorted", diff260)):
        pipeline.reset_counters()
        th = pipeline.treelet_intersect(archT, wro, wrd, active=wact)
        n_fb = pipeline.fallback_rays(dev)
        kh = wide.intersect_wide(archT, wro, wrd, active=wact)
        agree, ties, max_ulp, _ = hits_agree(archT, wro, wrd, kh.t, kh.tri,
                                             th.t, th.tri)
        ok_w = agree == 1.0 and max_ulp <= 2
        ok &= ok_w
        n_act = max(int(wact.sum()), 1)
        rows.append(f"| {name} | {N} | {agree:.6f} ({ties} ties) | "
                    f"{max_ulp} | {n_fb} ({n_fb / n_act:.4%}) | "
                    f"{'PASS' if ok_w else 'FAIL'} |")
    nro, nrd, ndist, nact = nee
    pipeline.reset_counters()
    blocked = pipeline.treelet_occluded(archT, nro, nrd, ndist, active=nact)
    n_fb = pipeline.fallback_rays(dev)
    want = wide.occluded_wide(archT, nro, nrd, ndist * (1.0 - 1e-3),
                              active=nact)
    b_agree = float((blocked == want).float().mean())
    ok &= b_agree == 1.0
    rows.append(f"| NEE of the primary wave (treelet_occluded vs K1 any-hit) "
                f"| {N} | blocked equal {b_agree:.6f} | - | {n_fb} "
                f"({n_fb / max(int(nact.sum()), 1):.4%}) | "
                f"{'PASS' if b_agree == 1.0 else 'FAIL'} |")
    print("\n".join(rows), flush=True)
    if not ok:
        raise SystemExit("chip_smoke: the treelet traversal disagrees with "
                         "K1")
    for name, (wro, wrd, wact) in (("primary", prim),
                                   ("diffuse, sorted", diff260)):
        by_stage = {}
        for rep in range(6):  # the first is a warm-up
            timer = StageTimer()
            pipeline.treelet_intersect(archT, wro, wrd, active=wact,
                                       mark=timer)
            for k, v in timer.ms().items():
                if rep:
                    by_stage[k] = by_stage.get(k, 0.0) + v / 5
        k1_wave = cuda_ms(lambda: wide.intersect_wide(archT, wro, wrd,
                                                      active=wact), 10)
        print(f"one {name} 1080p wave: treelet path "
              f"{sum(by_stage.values()):.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in by_stage.items())
              + f"); K1 path (intersect_wide with recompute_uv) "
              f"{k1_wave:.3f} ms ({smi})", flush=True)
    # Phase 2 on the card, under torch.profiler: its device kernels, by
    # name. E7 gathers each pair's ray and combines per ray itself, so no
    # gather (index) or scatter_reduce kernel may run in it.
    def phase2():
        return pipeline._phase2_combine(td, pro, prd, tfar, pray, on, sid,
                                        any_hit=False)

    kernels_run = {}
    for name, _ in device_kernels(
            phase2, lambda ks: any("lane_bottom" in n for n, _ in ks)):
        kernels_run[name] = kernels_run.get(name, 0) + 1
    print(f"phase 2 of one primary wave (_phase2_combine): device kernels "
          f"{kernels_run}")
    if not kernels_run:
        print("torch.profiler recorded no device kernel: the StageTimer "
              "split above stands alone")
    elif (not any("lane_bottom" in k for k in kernels_run)
          or any("index" in k or "scatter" in k for k in kernels_run)):
        raise SystemExit("chip_smoke: phase 2 launched a gather or scatter "
                         "kernel, or no E7")
    phase("treelet pipeline vs K1", t0)

    # -- The treelet frame: the headline frame on the treelet tables ---------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rt = lt.Renderer((WIDTH, HEIGHT),
                     lt.RenderConfig(downsample_factor=1.0, denoise=False))
    rt.set_resources(archT)
    rt.accumulate = True
    view = lt.arch_camera()
    for m in (wide, bvh2, ss, regroup, lane_top, lane_bottom, pipeline):
        m.reset_counters()
    rt.raytrace(view)  # warm-up frame; accum == its sample
    first = rt.accum.clone()
    frame_ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rt.raytrace(view)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    img = rt.blit()
    n_frames = 6
    k4_cuda, e5_cuda = ss.cuda_launched, regroup.cuda_launched
    t_launches = {"E6": lane_top.launches["pairs"],
                  "E6 per ray": lane_top.launches["per_ray"],
                  "K4": ss.launches,
                  "E5": regroup.launches["blocks"],
                  "E5 runs": regroup.launches["runs"],
                  "E7 closest": lane_bottom.launches[("per_ray", "closest")],
                  "E7 any-hit": lane_bottom.launches[("per_ray", "anyhit")],
                  "E7 per pair": lane_bottom.launches[("per_pair",
                                                       "closest")],
                  "E7 per pair any-hit": lane_bottom.launches[("per_pair",
                                                               "anyhit")],
                  "K1 closest": wide.launches_closest,
                  "K1 any-hit": wide.launches_anyhit,
                  "K2": bvh2.launches_closest, "K3": bvh2.launches_occluded}
    capped = (wide.capped_rays(dev) + bvh2.capped_rays(dev)
              + lane_top.capped_rays(dev) + lane_bottom.capped_pairs(dev))
    n_fb = pipeline.fallback_rays(dev)
    per_frame = {k: v / n_frames for k, v in t_launches.items()}
    print(f"treelet path: {n_frames} frames; launches {t_launches} "
          f"({per_frame} a frame); K4's CUDA launches {k4_cuda}, E5's "
          f"{e5_cuda}; "
          f"fallback rays {n_fb} ({n_fb / n_frames:.0f} a frame, "
          f"{n_fb / (n_frames * BOUNCES * N):.4%} of the closest-hit ray "
          f"slots); lanes stopped by a step bound {capped}")
    for k in ("E6", "K4", "E5", "E7 closest"):
        if t_launches[k] != BOUNCES * n_frames:
            raise SystemExit(f"chip_smoke: the treelet path launched {k} "
                             f"{t_launches[k]} times, not {BOUNCES} a frame")
    # Every E6 launch of the frame is the compacting epilogue, every E5
    # launch the path's entry, every E7 launch the per-ray epilogue in
    # closest-hit mode.
    for k in ("E6 per ray", "E5 runs", "E7 any-hit", "E7 per pair",
              "E7 per pair any-hit"):
        if t_launches[k]:
            raise SystemExit(f"chip_smoke: the treelet path launched {k} "
                             f"{t_launches[k]} times")
    # Every treelet sort has one payload and a slab of at most 2^16 keys.
    if k4_cuda != t_launches["K4"] * ss.cuda_launches(16, 1):
        raise SystemExit(f"chip_smoke: K4's {t_launches['K4']} sorts made "
                         f"{k4_cuda} CUDA launches, not their plans'")
    if e5_cuda != 3 * t_launches["E5"]:
        raise SystemExit(f"chip_smoke: E5's {t_launches['E5']} calls made "
                         f"{e5_cuda} CUDA launches, not 3 each")
    if capped:
        raise SystemExit("chip_smoke: lanes reached a step bound")
    if not (torch.isfinite(rt.accum).all() and img.shape ==
            (HEIGHT, WIDTH, 3) and img.dtype == np.uint8):
        raise SystemExit("chip_smoke: non-finite or misshapen treelet frame")
    nonzero = float((first.reshape(-1, 3).sum(1) > 0).float().mean())
    tms = float(np.mean(frame_ms))
    print(f"treelet frame ms (CUDA events): mean {tms:.3f}, min "
          f"{min(frame_ms):.3f}, all {[round(x, 3) for x in frame_ms]}; "
          f"Mrays/s {WIDTH * HEIGHT * BOUNCES * 2 / tms / 1e3:.3f}; "
          f"nonzero_pixel_frac (1 spp) {nonzero:.4f}; image mean "
          f"{float(rt.accum.mean()):.5f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})",
          flush=True)
    if nonzero < 0.5:
        raise SystemExit("chip_smoke: the treelet frame is mostly black")
    phase("treelet path (warm-up + 5 frames + blit)", t0)

    # Small frame: the treelet path against the K1 path on the card, the
    # same uniforms, sort off.
    t0 = time.perf_counter()
    gu.manual_seed(7)
    uni = draw_uniforms(w * h, BOUNCES, gu, "cpu").to(dev)
    a = trace_paths(archT, cam, w, h, bounces=BOUNCES, sort_rays=False,
                    uniforms=uni)[0]
    b = trace_paths(dataclasses.replace(archT, treelet=None), cam, w, h,
                    bounces=BOUNCES, sort_rays=False, uniforms=uni)[0]
    close = float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(1)
                  .float().mean())
    rel = abs(float(a.mean()) / max(float(b.mean()), 1e-12) - 1.0)
    print(f"small frame {w}x{h}, treelet path vs K1 path on the card: pixels "
          f"close {close:.5f}, mean rel diff {rel:.2e}")
    if close < 0.995 or rel > 1e-3:
        raise SystemExit("chip_smoke: the treelet frame disagrees with the "
                         "K1 path's")
    phase("treelet frame vs K1 frame", t0)

    # -- E1: the step-cost probe's path ------------------------------------
    # kernel_probe.main on the arch-260k scene built above (what its own
    # measure_traversal.build makes), its launches counted around it (K1
    # too: make_waves traces the primary wave with it); then each
    # variant's last outputs against the twin on the same inputs.
    t0 = time.perf_counter()
    del rt, archT, td
    torch.cuda.empty_cache()
    kernel_probe.reset_counters()
    wide.reset_counters()
    e1 = kernel_probe.main(bufs=arch, cam=cam)
    e1_launches = dict(kernel_probe.launches)
    e1_path = {"K1 closest": wide.launches_closest,
               "K1 any-hit": wide.launches_anyhit}
    print(f"E1 path launches {e1_launches}; on the way to it {e1_path}",
          flush=True)
    if not (all(e1_launches.values()) and e1_path["K1 closest"]):
        raise SystemExit("chip_smoke: the E1 path did not launch every "
                         "variant, or K1 for its primary wave")
    e1_args = e1["inputs"]
    G1 = e1_args[1].shape[0]
    N1 = G1 * 1024
    rows = ["| variant | kernel ms | twin ms | t,u,v,tri,steps equal (3 "
            "runs) | dropped pushes (kernel / twin) | steps mean / max | "
            "hit frac | box tests (on planes) | bound ms (which) | verdict |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    e1_res, ok = {}, True
    for probe, res in e1["probes"].items():
        st = {}
        kw = kernel_probe.probe_kwargs(arch, probe)
        d0 = kernel_probe.dropped_pushes(dev)
        p_ms, pout = timed(lambda: kernel_probe.probe_trace_plain(
            *e1_args, **kw, stats=st), 1, warm=False)
        p_drop = kernel_probe.dropped_pushes(dev) - d0
        kout = res["outputs"]
        # Three more kernel runs, each held to the twin's one run: the
        # packet's state is shared across lanes, and no race checker runs
        # on the card.
        same = [all(bits_equal(a, b) for a, b in zip(kout, pout))]
        drops = [res["dropped"]]
        for _ in range(3):
            d0 = kernel_probe.dropped_pushes(dev)
            again = kernel_probe.probe_trace(*e1_args, **kw)
            torch.cuda.synchronize()
            drops.append(kernel_probe.dropped_pushes(dev) - d0)
            same.append(all(bits_equal(a, b) for a, b in zip(again, pout)))
        drop_ok = (all(d == p_drop for d in drops)
                   and (probe == "nofetch" or p_drop == 0))
        # Bytes: each lane's rays (24), t0, act in and t, u, v, tri out
        # once, the steps once, the table once. Operations: the box tests
        # of children with a pointer, those on the packet's planes at
        # OPS_PLANE, and the triangle tests.
        planes = st["plane_tests"]
        b_ms, b_by = bound_of(N1 * (24 + 4 + 4 + 16) + G1 * 8 * 4
                              + trav_bytes,
                              (st["box_tests"] - planes) * OPS_BOX
                              + planes * OPS_PLANE
                              + st["tri_tests"] * OPS_TRI)
        err = float((kout[0] - pout[0]).abs().max())
        ok_p = all(same) and drop_ok
        ok &= ok_p
        e1_res[probe] = {"ms": res["ms"], "plain_ms": p_ms,
                         "bound": (b_ms, b_by), "err": err, "res": res}
        rows.append(f"| {probe} | {res['ms']:.3f} | {p_ms:.1f} | "
                    f"{'/'.join(str(x) for x in same)} | "
                    f"{'/'.join(str(d) for d in drops)} / {p_drop} | "
                    f"{res['steps_mean']:.1f} / {res['steps_max']} | "
                    f"{float((kout[3] >= 0).float().mean()):.4f} | "
                    f"{st['box_tests']} ({planes / max(st['box_tests'], 1):.4f})"
                    f" | {b_ms:.4f} ({b_by}) | {'PASS' if ok_p else 'FAIL'} |")
    # full's closest hits against K1 on the same rays.
    dro1 = torch.stack([e1_args[a].reshape(-1) for a in (1, 2, 3)], 1)
    drd1 = torch.stack([e1_args[a].reshape(-1) for a in (4, 5, 6)], 1)
    act1 = e1_args[8].reshape(-1) > 0
    kt1, ktri1 = wide.wide_trace(arch.trav_rows, dro1, drd1,
                                 torch.full((N1,), 1e30, device=dev), act1,
                                 False, arch.wide_end, arch.wide_stack)
    fo = e1["probes"]["full"]["outputs"]
    agree, ties, max_ulp, _ = hits_agree(arch, dro1, drd1, kt1, ktri1,
                                         fo[0].reshape(-1), fo[3].reshape(-1))
    k1_ok = agree == 1.0 and max_ulp <= 2
    rows.append(f"full vs K1 on all {N1} rays: tri agree {agree:.6f} ({ties} "
                f"ties), t max ulp {max_ulp}: {'PASS' if k1_ok else 'FAIL'}")
    print("\n".join(rows), flush=True)
    print(f"E1 on the sorted arch-260k 1080p diffuse wave ({G1 * 8} packets "
          f"of 128 rays) ({smi})", flush=True)
    if not (ok and k1_ok):
        raise SystemExit("chip_smoke: E1 disagrees with its plain version or "
                         "with K1, or dropped pushes")
    phase("E1: path + five variants vs twin", t0)

    # -- E2: the lane-gather probe's path ----------------------------------
    t0 = time.perf_counter()
    lane_gather_bench.reset_counters()
    e2 = lane_gather_bench.main()
    e2_launches = lane_gather_bench.launches
    if not e2_launches:
        raise SystemExit("chip_smoke: the E2 path did not launch E2")
    e2_args = [torch.from_numpy(a).to(dev)
               for a in lane_gather_bench.inputs()]
    e2_plain, p2 = timed(lambda: lane_gather_bench.lane_gather_plain(
        *e2_args, steps=512), 1, warm=False)
    # Three kernel runs at 512 steps and one at 4,096, each held to the
    # twin, NaN counted equal; then the edge-case input (links with bits
    # above 1,023, non-finite origins and directions) at the path's width
    # and G = 1 and 3, at 512 steps.
    k2 = [lane_gather_bench.run(*e2_args, steps=512) for _ in range(3)]
    e2_same = [nan_equal(k, p2) for k in k2]
    e2_same.append(nan_equal(
        lane_gather_bench.run(*e2_args, steps=4096),
        lane_gather_bench.lane_gather_plain(*e2_args, steps=4096)))
    e2_cases = {}
    for label, G, kw in (
            ("edge", lane_gather_bench.BLOCKS,
             {"high_links": True, "nonfinite": True}),
            ("G=1", 1, {}), ("G=3", 3, {})):
        a = [torch.from_numpy(x).to(dev)
             for x in lane_gather_bench.inputs(G, **kw)]
        ke = lane_gather_bench.run(*a, steps=512)
        pe = lane_gather_bench.lane_gather_plain(*a, steps=512)
        e2_cases[label] = (nan_equal(ke, pe),
                           float(torch.isnan(pe).float().mean()))
    e2_err = float((k2[0] - p2).abs().max())
    lanes2 = e2_args[1].numel()
    # Bytes: the table, each lane's rays in and its sum out once.
    e2_bound = bound_of(7 * 1024 * 4 + lanes2 * 7 * 4,
                        lanes2 * 512 * OPS_BOX)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print("ptxas, csrc/lane_gather.cu:\n" + ptxas_lines("lane_gather"),
          flush=True)
    print(f"E2 launch: {e2_args[1].shape[0]} blocks of 1,024 lanes, one "
          f"block an SM by the kernel's dynamic shared memory, so on "
          f"{min(e2_args[1].shape[0], n_sm)} of the card's {n_sm} SMs "
          f"(computed, not read on the card)", flush=True)
    print(f"E2 path launches {e2_launches}; at {e2_args[1].shape[0]} x 1024 "
          f"lanes: equal at 512 steps (3 runs) and 4,096 "
          f"{'/'.join(str(x) for x in e2_same)}; "
          + "; ".join(f"{k} equal {v[0]} (NaN share {v[1]:.4f})"
                      for k, v in e2_cases.items())
          + f"; kernel {e2['ms'][512]:.4f} ms at 512 steps, plain torch "
          f"{e2_plain:.3f} ms, bound {e2_bound[0]:.4f} ms ({e2_bound[1]}); "
          f"slope {e2['per_step_ns']:.3f} ns a "
          f"step of all lanes (the reference's per-block figure "
          f"{e2['ref_per_block_ns']:.3f} ns) ({smi})", flush=True)
    if not (all(e2_same) and all(v[0] for v in e2_cases.values())):
        raise SystemExit("chip_smoke: E2 disagrees with its plain version")
    phase("E2: path + check", t0)

    # -- E3: the op-latency probes' path -----------------------------------
    t0 = time.perf_counter()
    r3_probes.reset_counters()
    e3 = r3_probes.main(["all"])
    e3_launches = dict(r3_probes.launches)
    if not all(e3_launches.values()):
        raise SystemExit("chip_smoke: the E3 path did not launch every probe")
    x3 = r3_probes.tile(dev)
    rows = ["| probe | ns / step (slope) | kernel ms (256 steps) | twin ms | "
            "bound ms (operations, one SM) | equal (3 runs at 256 steps; "
            "1,024 steps) | verdict |",
            "|---|---|---|---|---|---|---|"]
    e3_res, ok = {}, True
    for name in r3_probes.PROBES:
        k_ms, k3 = timed(lambda: r3_probes.run_probe_kernel(name, x3, 256), 5)
        p_ms, p3 = timed(lambda: r3_probes.probe_plain(name, x3, 256), 1,
                         warm=False)
        # Two more runs at 256 steps, and one at 1,024 against its own
        # twin, so that a drift that needs many steps shows.
        same = [bits_equal(k3, p3)] + [
            bits_equal(r3_probes.run_probe_kernel(name, x3, 256), p3)
            for _ in range(2)]
        same.append(bits_equal(r3_probes.run_probe_kernel(name, x3, 1024),
                               r3_probes.probe_plain(name, x3, 1024)))
        ok &= all(same)
        # One block runs on one SM: its share of the FP32 rate.
        ops = 256 * r3_probes.OPS_PER_STEP[name]
        b_ms = ops / (PEAK_FLOP_S / 132) * 1e3
        e3_res[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "err": float((k3 - p3).abs().max()),
                        "ns": e3[name]["ns_per_step"]}
        rows.append(f"| {name} | {e3[name]['ns_per_step']:.3f} | {k_ms:.4f} | "
                    f"{p_ms:.1f} | {b_ms:.5f} | "
                    f"{'/'.join(str(x) for x in same)} | "
                    f"{'PASS' if all(same) else 'FAIL'} |")
    print("\n".join(rows), flush=True)
    print(f"E3 path launches {e3_launches} ({smi})", flush=True)
    print("ptxas, csrc/kernel_probe.cu:\n" + ptxas_lines("kernel_probe")
          + "\nptxas, csrc/r3_probes.cu:\n" + ptxas_lines("r3_probes"),
          flush=True)
    if not ok:
        raise SystemExit("chip_smoke: E3 disagrees with its plain version")
    phase("E3: path + ten probes vs twin", t0)

    # E1 (five variants) and E3's segmin on non-finite inputs: their min /
    # max return NaN, as the twins' torch.minimum / maximum do. E1 on
    # NONFINITE_PACKETS packets of the sorted diffuse wave of arch-4k
    # (256x128) with the edge cases of nonfinite_rays: a ray with an
    # infinite direction component tests no triangle and walks every row
    # of the table, and the twin steps until its longest packet ends, so
    # the check takes arch-4k's small table, not arch-260k's; segmin on a
    # tile with NaN and +-inf entries.
    t0 = time.perf_counter()
    arch4, cam4 = measure_traversal.build(dev, 4_000)
    gp = NONFINITE_PACKETS // 8
    w4 = gp * 1024 // 128
    nro, nrd, alive4 = kernel_probe.sorted_diffuse_wave(arch4, cam4, w4,
                                                         128)
    nro, nrd = nonfinite_rays(nro, nrd, 46)
    bad = int((~(torch.isfinite(nro).all(1) & torch.isfinite(nrd).all(1)))
              .sum())
    nf_args = kernel_probe.probe_args(arch4, nro, nrd, alive4)
    rows = [f"| E1 variant on {gp * 8} arch-4k packets ({gp * 1024} rays, "
            f"{bad} non-finite) | t,u,v NaN-equal, tri, steps equal (3 runs) | "
            "dropped (kernel / twin) | steps max / bound | verdict |",
            "|---|---|---|---|---|"]
    nf_probe_ok = True
    for probe in kernel_probe.PROBES:
        kw = kernel_probe.probe_kwargs(arch4, probe)
        d0 = kernel_probe.dropped_pushes(dev)
        want = kernel_probe.probe_trace_plain(*nf_args, **kw)
        p_drop = kernel_probe.dropped_pushes(dev) - d0
        same, drops = [], []
        for _ in range(3):
            d0 = kernel_probe.dropped_pushes(dev)
            got = kernel_probe.probe_trace(*nf_args, **kw)
            torch.cuda.synchronize()
            drops.append(kernel_probe.dropped_pushes(dev) - d0)
            same.append(all(nan_equal(a, b) if a.dtype == torch.float32
                            else bits_equal(a, b) for a, b in zip(got, want)))
        smax = int(want[4].max())
        # nofetch walks its fixed bound by design; the others end in it.
        in_bound = probe == "nofetch" or smax < kw["max_steps"]
        ok_p = (all(same) and all(d == p_drop for d in drops)
                and (probe == "nofetch" or p_drop == 0) and in_bound)
        nf_probe_ok &= ok_p
        rows.append(f"| {probe} | {'/'.join(map(str, same))} | "
                    f"{'/'.join(map(str, drops))} / {p_drop} | {smax} / "
                    f"{kw['max_steps']} | {'PASS' if ok_p else 'FAIL'} |")
    x_nf = r3_probes.tile(dev).clone().reshape(8, 128)
    for (r, c), v in (((0, 5), "nan"), ((1, 40), "-inf"), ((2, 70), "inf"),
                      ((3, 100), "nan"), ((3, 101), "-inf"),
                      ((7, 127), "nan")):
        x_nf[r, c] = float(v)
    x_nf[5, :32] = float("inf")
    x_nf = x_nf.reshape(1, 8, 128).contiguous()
    want3 = r3_probes.probe_plain("segmin", x_nf, 256)
    seg_same = [nan_equal(r3_probes.run_probe_kernel("segmin", x_nf, 256),
                          want3) for _ in range(3)]
    n_nan = int(torch.isnan(want3).sum())
    rows.append(f"E3 segmin on a tile with NaN and +-inf entries, 256 steps: "
                f"three runs NaN-equal to the twin {seg_same} ({n_nan} NaN "
                f"of 1024 in the twin's output): "
                f"{'PASS' if all(seg_same) else 'FAIL'}")
    print("\n".join(rows), flush=True)
    phase("E1/E3 on non-finite inputs", t0)
    if not (nf_probe_ok and all(seg_same)):
        raise SystemExit("chip_smoke: E1 or E3's segmin disagrees with its "
                         "plain version on non-finite inputs")

    # -- E4: the global sort's path ----------------------------------------
    t0 = time.perf_counter()
    ss.reset_counters()
    e4 = device_sort_bench.main()
    e4_launches = ss.launches
    e4_cuda = ss.cuda_launched
    if not (e4_launches and e4["correct"]):
        raise SystemExit("chip_smoke: the E4 path did not launch K4 or "
                         "sorted wrongly")
    n4 = 8_388_608
    _, keys4, vals4 = device_sort_bench.inputs(n4, dev)
    mat4, c4 = ss.pack(keys4, [vals4], slab_log=64)
    if e4_cuda != e4_launches * ss.cuda_launches(c4, 1):
        raise SystemExit(f"chip_smoke: the E4 path's {e4_launches} sorts "
                         f"made {e4_cuda} CUDA launches, not their plans'")
    e4_plain, p4m = timed(lambda: ss.slab_sort_plain(mat4.clone(), c4), 1,
                          warm=False)
    lk4, _ = device_sort_bench.library_sort(keys4, vals4)
    e4_same = e4_lib = True
    e4_err = 0.0
    for _ in range(3):  # a race would break equality only some of the time
        k4m = ss.sort_matrix(mat4.clone(), c4)
        ks4, vs4 = device_sort(keys4, vals4)
        torch.cuda.synchronize()
        e4_same &= bits_equal(k4m, p4m) and bits_equal(
            ks4, k4m[0, :n4]) and bits_equal(vs4, k4m[1, :n4])
        e4_lib &= bool(torch.equal(lk4, ks4)) and bool(
            torch.equal(keys4[vs4.long()], ks4))
        e4_err = max(e4_err, float((k4m.to(torch.int64) -
                                    p4m.to(torch.int64)).abs().max()))
    n_pad = mat4.shape[1]
    # Operations: a compare and two selects per compare-exchange, n_pad / 2
    # of them in each of the c4 (c4 + 1) / 2 stages; bytes: keys and vals
    # read and written once.
    e4_bound = bound_of(2 * mat4.numel() * 4,
                        (n_pad // 2) * (c4 * (c4 + 1) // 2) * 3)
    print(f"E4 path launches (K4 wrapper) {e4_launches}, CUDA launches "
          f"made {e4_cuda} ({ss.cuda_launches(c4, 1)} a sort in its plan, "
          f"c_log {c4}: {ss.launch_plan(c4, 1)}); device_sort on {n4} keys, three "
          f"repeats: matrix and output equal to "
          f"slab_sort_plain {e4_same}, keys equal to torch.sort and payload "
          f"riding with its key {e4_lib}; device_sort {e4['device_sort']:.3f}"
          f" ms, torch.sort + gather {e4['torch.sort+gather']:.3f} ms, plain "
          f"torch {e4_plain:.1f} ms, bound {e4_bound[0]:.4f} ms "
          f"({e4_bound[1]}) ({smi})", flush=True)
    if not (e4_same and e4_lib):
        raise SystemExit("chip_smoke: E4 disagrees with its plain version or "
                         "with torch.sort")
    phase("E4: path + check", t0)

    app = app_phases(lt, dev, arch, arch40, smi)

    kernels = []
    for mode, err in (("closest", k1_err[0]), ("anyhit", k1_err[1])):
        b_ms, b_by = k1_bound[mode]
        kernels.append({
            "name": f"wide_traverse ({mode})", "route": "cuda",
            "source": "loupiote_tpu_torch/csrc/wide_traverse.cu",
            "replaces": "loupiote_tpu/ops/pallas_wide.py:160",
            # The headline frame's launches, the tile frames' and the
            # instanced frame's.
            "launches": k1_launches[mode] + tile_launches[mode]
            + inst_res["launches"]["K1 " + mode.replace("anyhit", "any-hit")],
            "max_abs_err": max(err, inst_res["errs"]["K1"]),
            "ms": k1_timing[mode][0], "plain_ms": k1_timing[mode][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "nonfinite_equal": nf_equal[
                "K1 " + mode.replace("anyhit", "any-hit")],
            # K1's launches a frame on each 1080p frame of this run.
            "path_launches_per_frame": {
                name: f["k1_launches_per_frame"][mode]
                for name, f in frames.items()}})
    any_ms, any_plain = k23_timing["K2 any-hit"]
    for name, line, key, err_key in (
            ("bvh2_trace", 67, "K2 closest", "closest"),
            ("bvh2_occluded", 260, "K3", "occluded")):
        b_ms, b_by = k23_bound[key]
        entry = {
            "name": name, "route": "cuda",
            "source": "loupiote_tpu_torch/csrc/bvh2_traverse.cu",
            "replaces": f"loupiote_tpu/ops/pallas_intersect.py:{line}",
            "launches": launches[key] + inst_res["launches"].get(key, 0),
            "max_abs_err": max(k23_err[err_key], inst_res["errs"]["K2"]
                               if name == "bvh2_trace" else 0.0),
            "ms": k23_timing[key][0], "plain_ms": k23_timing[key][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "nonfinite_equal": nf_equal[key] and (
                name != "bvh2_trace" or nf_equal["K2 any-hit"])}
        if name == "bvh2_trace":
            # K2's top-level numbers are the primary wave's; the diffuse
            # wave's beside them, the interactive frame's launches summed
            # (torch.profiler), and the any-hit mode, checked and timed
            # here, not on the path.
            entry["modes"] = {
                "diffuse": {
                    "ms": k23_timing["K2 diffuse"][0],
                    "plain_ms": k23_timing["K2 diffuse"][1],
                    "bound_ms": k23_bound["K2 diffuse"][0],
                    "bound_by": k23_bound["K2 diffuse"][1],
                    "k1_closest_ms": k1_40["diffuse"]},
                "frame": {"launches": n_k2, "ms": k2_frame_ms,
                          "ms_by_launch": k2_frame,
                          "capped": frame_capped},
                "instanced": {
                    # The instanced frame's K2 calls of its primary and
                    # first NEE traversals against the twin; its launches
                    # are in the counts above.
                    "launches": inst_res["launches"]["K2 closest"]
                    + inst_res["launches"]["K2 any-hit"],
                    "calls_checked": inst_res["calls_checked"],
                    "max_abs_err": inst_res["errs"]["K2"]},
                "anyhit": {
                    "launches": launches["K2 any-hit"]
                    + inst_res["launches"]["K2 any-hit"],
                    "max_abs_err": k23_err["anyhit"], "ms": any_ms,
                    "plain_ms": any_plain,
                    "bound_ms": k23_bound["K2 any-hit"][0],
                    "bound_by": k23_bound["K2 any-hit"][1]}}
            entry["k1_closest_ms"] = k1_40["closest"]
        else:
            # K3's top-level numbers are the NEE wave's; the diffuse shadow
            # wave's beside them, and the interactive frame's launches
            # summed (torch.profiler).
            entry["modes"] = {
                "diffuse_shadow": {
                    "ms": k23_timing["K3 diffuse"][0],
                    "plain_ms": k23_timing["K3 diffuse"][1],
                    "bound_ms": k23_bound["K3 diffuse"][0],
                    "bound_by": k23_bound["K3 diffuse"][1],
                    "k1_anyhit_ms": k1_40["anyhit diffuse"]},
                "frame": {"launches": n_k3, "ms": k3_frame_ms,
                          "ms_by_launch": k3_frame,
                          "capped": frame_capped}}
            entry["k1_anyhit_ms"] = k1_40["anyhit"]
        kernels.append(entry)
    kernels.append({
        "name": "slab_sort", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/slab_sort.cu",
        "replaces": "loupiote_tpu/ops/slab_sort.py:81",
        "launches": t_launches["K4"], "cuda_launches": k4_cuda,
        "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain, "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1], "library_ms": k4_lib})
    # E5's path entry is what the treelet path runs (its plain version:
    # block_runs + scatter_runs_plain + block_layout); the run-list entry
    # (the TPU kernel's own function, counting_regroup's) is checked and
    # timed here, off the path (its launches on the path are counted: 0).
    et5 = e5_timing["primary"]
    kernels.append({
        "name": "regroup_blocks", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/regroup.cu",
        "replaces": "experiments/treelet/regroup.py:53",
        "launches": t_launches["E5"], "cuda_launches": e5_cuda,
        "max_abs_err": e5_err["blocks"], "ms": et5["blocks"],
        "plain_ms": et5["blocks_plain"], "bound_ms": e5_bound["blocks"][0],
        "bound_by": e5_bound["blocks"][1], "library_ms": None,
        "diffuse_ms": e5_timing["diffuse, sorted"]["blocks"],
        "ms_by_launch": et5["by_launch"],
        "parent_binning_ms": et5["chain"],
        "modes": {"scatter_runs": {
            "launches": t_launches["E5 runs"],
            "max_abs_err": e5_err["runs"], "ms": et5["runs"],
            "plain_ms": et5["runs_plain"], "bound_ms": e5_bound["runs"][0],
            "bound_by": e5_bound["runs"][1], "library_ms": None}}})
    # E6's compacting epilogue is what the path runs (its plain version:
    # the plain walk, then compact_pairs); the per-ray one is checked and
    # timed here, off the path (its launches on the path are counted: 0).
    et = e6_timing["primary"]
    kernels.append({
        "name": "lane_top", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/treelet_traverse.cu",
        "replaces": "experiments/treelet/lane_top.py:178",
        "launches": t_launches["E6"], "max_abs_err": lane_err["E6 pairs"],
        "nonfinite_equal": lanes_nf[0],
        "ms": et["pairs"], "plain_ms": et["plain"] + et["compact_pairs"],
        "bound_ms": e6_bound["pairs"][0], "bound_by": e6_bound["pairs"][1],
        "library_ms": None,
        "diffuse_ms": e6_timing["diffuse, sorted"]["pairs"],
        "modes": {"per_ray": {
            "launches": t_launches["E6 per ray"],
            "max_abs_err": lane_err["E6"], "ms": et["per_ray"],
            "plain_ms": et["plain"], "bound_ms": e6_bound["per_ray"][0],
            "bound_by": e6_bound["per_ray"][1],
            "diffuse_ms": e6_timing["diffuse, sorted"]["per_ray"]}}})
    def e7_entry(epi, m):
        b_ms, b_by = e7_bound[(epi, m)]
        err = lane_err[(epi, m)]
        if epi == "per pair":  # with the two waves' subset checks
            err = max(err, lane_err[m])
        return {"max_abs_err": err, "ms": e7_timing[(epi, m)][0],
                "plain_ms": e7_timing[(epi, m)][1], "bound_ms": b_ms,
                "bound_by": b_by}

    kernels.append({
        "name": "lane_bottom", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/treelet_traverse.cu",
        "replaces": "experiments/treelet/lane_bottom.py:63",
        "launches": t_launches["E7 closest"],
        **e7_entry("per ray", "closest"), "library_ms": None,
        "nonfinite_equal": lanes_nf[1],
        # The per-ray epilogue in closest-hit mode is what the path runs;
        # its any-hit mode and the per-pair epilogue are checked and timed
        # here, off the path (their launches on the path are counted: 0).
        "modes": {"anyhit": {"launches": t_launches["E7 any-hit"],
                             **e7_entry("per ray", "anyhit")},
                  "per_pair": {"launches": t_launches["E7 per pair"],
                               **e7_entry("per pair", "closest")},
                  "per_pair_anyhit": {
                      "launches": t_launches["E7 per pair any-hit"],
                      **e7_entry("per pair", "anyhit")}}})
    full = e1_res["full"]
    kernels.append({
        "name": "kernel_probe", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/kernel_probe.cu",
        "replaces": "experiments/kernel_probe.py:45",
        "launches": sum(e1_launches.values()),
        "max_abs_err": max(r["err"] for r in e1_res.values()),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound"][0], "bound_by": full["bound"][1],
        "library_ms": None, "nonfinite_equal": nf_probe_ok,
        # Other kernels that kernel_probe.main launches (make_waves).
        "path_launches": {"K1": e1_path["K1 closest"] + e1_path["K1 any-hit"]},
        # Each variant on the same wave; the top-level numbers are full's.
        "modes": {p: {"launches": e1_launches[p], "max_abs_err": r["err"],
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                      "library_ms": None,
                      "steps_mean": r["res"]["steps_mean"],
                      "dropped_pushes": r["res"]["dropped"]}
                  for p, r in e1_res.items()}})
    kernels.append({
        "name": "lane_gather", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/lane_gather.cu",
        "replaces": "experiments/lane_gather_bench.py:40",
        "launches": e2_launches, "max_abs_err": e2_err,
        "ms": e2["ms"][512], "plain_ms": e2_plain, "bound_ms": e2_bound[0],
        "bound_by": e2_bound[1], "library_ms": None,
        "ms_by_steps": e2["ms"], "per_step_ns": e2["per_step_ns"],
        "ref_per_block_ns": e2["ref_per_block_ns"]})
    kernels.append({
        "name": "r3_probes", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/r3_probes.cu",
        "replaces": "experiments/r3_probes.py:147",
        "launches": sum(e3_launches.values()),
        "max_abs_err": max(r["err"] for r in e3_res.values()),
        # The ten probes at 256 steps, one call each, summed.
        "ms": sum(r["ms"] for r in e3_res.values()),
        "plain_ms": sum(r["plain_ms"] for r in e3_res.values()),
        "bound_ms": sum(r["bound_ms"] for r in e3_res.values()),
        "bound_by": "operations", "library_ms": None,
        "segmin_nonfinite_equal": all(seg_same),
        "modes": {n: {"launches": e3_launches[n], "max_abs_err": r["err"],
                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": "operations",
                      "library_ms": None, "ns_per_step": r["ns"]}
                  for n, r in e3_res.items()}})
    kernels.append({
        "name": "device_sort", "route": "cuda",
        "source": "loupiote_tpu_torch/csrc/slab_sort.cu",
        "replaces": "experiments/treelet/device_sort.py:81",
        "launches": e4_launches, "cuda_launches": e4_cuda,
        "max_abs_err": e4_err,
        "ms": e4["device_sort"], "plain_ms": e4_plain,
        "bound_ms": e4_bound[0], "bound_by": e4_bound[1],
        "library_ms": e4["torch.sort+gather"]})
    print(json.dumps({"kernels": kernels, "frames": frames, "app": app}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
