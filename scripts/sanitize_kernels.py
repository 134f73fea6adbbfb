#!/usr/bin/env python3
"""Small launches of K1, K2 and K4 for the CUDA toolkit's
compute-sanitizer (card only).

    compute-sanitizer --tool racecheck python3 scripts/sanitize_kernels.py
    compute-sanitizer --tool synccheck python3 scripts/sanitize_kernels.py
    compute-sanitizer --tool memcheck  python3 scripts/sanitize_kernels.py

Runs one small instanced wave (an arch-60k hall merged into one BLAS,
which K1 walks, and 20 props of two meshes, which K2 walks in both
modes through the candidate waves) at 256 x 128 rays, then K4 on one
2^16-key slab (a cluster launch, below its span) and on 2^20 keys in one
slab (its global passes, above the span). Each result is held to its
plain twin; the script exits non-zero on a disagreement. The sanitizer's
own report and exit code say whether it found a race, a barrier fault
or a bad access.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch.ops import bvh2, wide
    from loupiote_tpu_torch.ops import slab_sort as ss
    from loupiote_tpu_torch.ops.intersect import intersect_any
    from loupiote_tpu_torch.ops.raygen import generate_rays
    from loupiote_tpu_torch.scene.instanced import build_instanced_buffers

    if not torch.cuda.is_available():
        raise SystemExit("sanitize_kernels: needs a CUDA card")
    dev = torch.device("cuda")
    scene = lt.build_arch_scene(60_000, props=20, merged=True)
    inst = build_instanced_buffers(scene)
    w, h = 256, 128
    g = torch.Generator(device=dev).manual_seed(0)
    cam = torch.from_numpy(lt.arch_camera()).to(dev)
    ro, rd = generate_rays(cam, w, h, 0.7853982,
                           torch.rand(w * h, 2, generator=g, device=dev))
    ok = True
    for any_hit in (False, True):
        tmax = None if not any_hit else torch.full((w * h,), 20.0,
                                                   device=dev)
        got = intersect_any(inst, ro, rd, tmax=tmax, any_hit=any_hit)
        want = intersect_any(inst.to("cpu"), ro.cpu(), rd.cpu(),
                             tmax=None if tmax is None else tmax.cpu(),
                             any_hit=any_hit)
        same = torch.equal(got.tri.cpu() >= 0, want.tri >= 0) and (
            any_hit or torch.equal(got.tri.cpu(), want.tri))
        print(f"instanced wave {w}x{h} {'any-hit' if any_hit else 'closest'}"
              f": K1 launches {wide.launches_closest + wide.launches_anyhit}"
              f", K2 {bvh2.launches_closest + bvh2.launches_anyhit}; equal "
              f"to the CPU path {same}", flush=True)
        ok &= same
    rng = np.random.default_rng(1)
    for n in (1 << 16, 1 << 20):
        key = torch.from_numpy(rng.integers(0, 1 << 30, n, np.int32)).to(dev)
        col = torch.arange(n, dtype=torch.int32, device=dev)
        mat, c_log = ss.pack(key, [col], slab_log=int(np.log2(n)))
        plan = ss.launch_plan(c_log, 1)
        got = ss.sort_matrix(mat.clone(), c_log)
        want = ss.slab_sort_plain(mat.cpu(), c_log)
        same = torch.equal(got.cpu(), want)
        print(f"K4 on {n} keys: plan {plan}; equal to the twin {same}",
              flush=True)
        ok &= same
    torch.cuda.synchronize()
    print("sanitize_kernels: " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
