#!/usr/bin/env python3
"""Time the BVH2 kernels against the wide kernel across arch scene sizes
(needs CUDA and nvcc).

    python3 scripts/dispatch_threshold.py [triangles ...]

The port sends scenes under ``ops/intersect.py::_WIDE_MIN_NODES`` (8,192)
BVH2 nodes to K2 (closest-hit) and K3 (shadow rays), larger ones to K1.
For each ``build_arch_scene`` size (default 10k, 20k, 40k, 80k and 160k
triangles) this builds the 960x540 waves of ``chip_smoke.py`` (the primary
wave in tile order, its NEE wave, and the diffuse wave's shadow rays with
tmax 25) and times K2 against K1 closest-hit on the primary wave and on
the (unsorted) diffuse wave, the kind of the interactive frame's bounce
waves, and K3 against K1 any-hit on the two shadow waves (CUDA events,
mean of 20 after a warm-up). Beside the times, how far the two kernels'
answers agree: the share of closest hits on the same triangle or a t-tie
within 2 ulp, and the share of equal blocked bits (two trees over the same triangles; the
kernels are held to their own twins by chip_smoke.py). Prints one table
row a size, and the card's name and power limit.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZES = (10_000, 20_000, 40_000, 80_000, 160_000)


def main(argv=None):
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch.ops import bvh2, intersect, wide

    if not torch.cuda.is_available():
        raise SystemExit("dispatch_threshold: needs a GPU")
    sizes = [int(x) for x in (argv or [])] or list(SIZES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cam = torch.from_numpy(lt.arch_camera()).to(dev)
    w, h = 960, 540
    N = w * h
    rows = ["| triangles | BVH2 nodes | dispatch | K2 closest | K1 closest | "
            "K2 diffuse | K1 diffuse | K3 NEE | K1 any-hit NEE | K3 diffuse "
            "shadow | K1 any-hit diffuse shadow | closest / NEE / diffuse "
            "agree |",
            "|---" * 12 + "|"]
    for n in sizes:
        scene = lt.build_scene_buffers(lt.build_arch_scene(n))
        prim, nee, diff = cs.waves(scene, cam, w, h, seed=1)
        tfar = torch.full((N,), 1e30, device=dev)
        p = (prim[0], prim[1], tfar, prim[2])
        ds = (diff[0], diff[1], torch.full((N,), 25.0, device=dev), diff[2])
        dc = (diff[0], diff[1], tfar, diff[2])
        tb = (scene.node_rows, scene.leaf_rows)
        tr = (scene.num_nodes, scene.stack_depth)
        oc = (scene.end_index, scene.num_nodes)
        tw = (scene.trav_rows,)
        ws = (scene.wide_end, scene.wide_stack)
        calls = [
            lambda: bvh2.bvh2_trace(*tb, *p, False, *tr),
            lambda: wide.wide_trace(*tw, *p, False, *ws),
            lambda: bvh2.bvh2_trace(*tb, *dc, False, *tr),
            lambda: wide.wide_trace(*tw, *dc, False, *ws),
            lambda: bvh2.bvh2_occluded(*tb, *nee, *oc),
            lambda: wide.wide_trace(*tw, *nee, True, *ws),
            lambda: bvh2.bvh2_occluded(*tb, *ds, *oc),
            lambda: wide.wide_trace(*tw, *ds, True, *ws)]
        ms = [cs.cuda_ms(fn, 20) for fn in calls]
        k2 = calls[0]()
        k1 = calls[1]()
        agree = cs.hits_agree(scene, prim[0], prim[1], k2[0], k2[3], k1[0],
                              k1[1])[0]
        same = [float(((calls[4]() > 0) == (calls[5]()[1] > 0)).float()
                      .mean()),
                float(((calls[6]() > 0) == (calls[7]()[1] > 0)).float()
                      .mean())]
        path = ("K2/K3" if scene.num_nodes < intersect._WIDE_MIN_NODES
                else "K1")
        rows.append(f"| {n} | {scene.num_nodes} | {path} | "
                    + " | ".join(f"{x:.4f}" for x in ms)
                    + f" | {agree:.6f} / {same[0]:.6f} / {same[1]:.6f} |")
        print(rows[-1], flush=True)
    print("\n".join(rows))
    print(smi)
    capped = bvh2.capped_rays(dev) + wide.capped_rays(dev)
    if capped:
        raise SystemExit("dispatch_threshold: rays reached a step bound")


if __name__ == "__main__":
    main(sys.argv[1:])
