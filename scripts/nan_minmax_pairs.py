#!/usr/bin/env python3
"""E1, E3, E6 and E7 with NaN-returning min / max against the same kernels
with fminf / fmaxf, on one card (card only).

    python3 scripts/nan_minmax_pairs.py OLD_CSRC_DIR

OLD_CSRC_DIR holds the sources before the switch (for example
``loupiote_tpu_torch/csrc`` of an earlier commit's ``git archive``). Both
builds are loaded side by side (``_build._libs`` swapped between them) and
run in alternated order: old, new, new, old. Each run:

- holds E6 (both epilogues) and E7 (both epilogues and modes) to their
  twins on 4,096 rays of the arch-260k 1080p primary wave with the edge
  cases of ``nonfinite_rays``, E1's five variants on 256 packets of the
  sorted diffuse wave of arch-4k with those edge cases, and E3's segmin
  on a tile with NaN and +-inf entries (``chip_smoke.py``'s checks);
- times E1 ``full`` on the whole sorted diffuse wave, E6 per ray and
  compacting and E7 per ray (closest-hit) on the primary wave (mean of 10
  calls after a warm-up, CUDA events).
Prints one line a run and a JSON summary last.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("kernel_probe", "r3_probes", "treelet_traverse")


def main(old_dir):
    import torch

    import chip_smoke as cs
    from loupiote_tpu_torch import _build
    from loupiote_tpu_torch import build_arch_scene, build_scene_buffers
    from loupiote_tpu_torch.experiments import kernel_probe, r3_probes
    from loupiote_tpu_torch.experiments.measure_traversal import (build,
                                                                  make_waves)
    from loupiote_tpu_torch.scene import arch_camera
    from loupiote_tpu_torch.scene.fixtures import nonfinite_rays
    from loupiote_tpu_torch.treelet import lane_bottom, lane_top
    from loupiote_tpu_torch.treelet.regroup import block_regroup

    if not torch.cuda.is_available():
        raise SystemExit("nan_minmax_pairs: needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {}
    new_dir = _build.CSRC_DIR
    for tag, d in (("old", os.path.abspath(old_dir)), ("new", new_dir)):
        _build.CSRC_DIR = d
        for n in SOURCES:
            _build._libs.pop(n, None)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(SOURCES)) as ex:
            libs[tag] = dict(zip(SOURCES, ex.map(_build.load, SOURCES)))
        print(f"{tag} sources from {d}: built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    _build.CSRC_DIR = new_dir

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bufs = build_scene_buffers(build_arch_scene(260_000), treelets=True)
    td = bufs.treelet
    S = td.num_subtrees
    cam = torch.from_numpy(arch_camera()).to(dev)
    pro, prd, dro, drd, alive = make_waves(bufs, cam)
    N = pro.shape[0]
    pact = torch.ones(N, dtype=torch.bool, device=dev)
    tfar = torch.full((N,), 1e30, device=dev)
    e1_args = kernel_probe.probe_args(
        bufs, *kernel_probe.sorted_diffuse_wave(bufs, cam))
    key, ray_of, _ = lane_top.lane_top_pairs(td.top_fields, pro, prd, tfar,
                                             pact, td.num_top, S)
    pray, sid, on = block_regroup(key, ray_of, S)
    e7_ray = (sid, td.sub_fields, td.sub_tri_base, pray, on, pro, prd, tfar)
    print(f"arch-260k with treelets and its waves: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    arch4, cam4 = build(dev, 4_000)
    # NONFINITE_PACKETS packets of 128 rays: a NONFINITE_PACKETS x 128
    # image.
    nro, nrd, alive4 = kernel_probe.sorted_diffuse_wave(
        arch4, cam4, cs.NONFINITE_PACKETS, 128)
    nro, nrd = nonfinite_rays(nro, nrd, 46)
    nf_e1 = kernel_probe.probe_args(arch4, nro, nrd, alive4)
    x_nf = r3_probes.tile(dev).clone().reshape(8, 128)
    x_nf[0, 5] = x_nf[3, 100] = x_nf[7, 127] = float("nan")
    x_nf[1, 40] = x_nf[3, 101] = float("-inf")
    x_nf[2, 70] = float("inf")
    x_nf[5, :32] = float("inf")
    x_nf = x_nf.reshape(1, 8, 128).contiguous()
    full_kw = kernel_probe.probe_kwargs(bufs, "full")

    runs = []
    for tag in ("old", "new", "new", "old"):
        _build._libs.update(libs[tag])
        rows = []
        t1 = time.perf_counter()
        e6_ok, e7_ok = cs.compare_lanes_nonfinite(td, (pro, prd, pact), S,
                                                  45, rows)
        t2 = time.perf_counter()
        e1_ok = {}
        for probe in kernel_probe.PROBES:
            kw = kernel_probe.probe_kwargs(arch4, probe)
            want = kernel_probe.probe_trace_plain(*nf_e1, **kw)
            got = kernel_probe.probe_trace(*nf_e1, **kw)
            e1_ok[probe] = all(
                cs.nan_equal(a, b) if a.dtype == torch.float32
                else cs.bits_equal(a, b) for a, b in zip(got, want))
        t3 = time.perf_counter()
        seg_ok = cs.nan_equal(
            r3_probes.run_probe_kernel("segmin", x_nf, 256),
            r3_probes.probe_plain("segmin", x_nf, 256))
        t4 = time.perf_counter()
        ms = {
            "E1 full": cs.cuda_ms(lambda: kernel_probe.probe_trace(
                *e1_args, **full_kw), 10),
            "E6 per ray": cs.cuda_ms(lambda: lane_top.lane_top_trace(
                td.top_fields, pro, prd, tfar, pact, td.num_top), 10),
            "E6 compacting": cs.cuda_ms(lambda: lane_top.lane_top_pairs(
                td.top_fields, pro, prd, tfar, pact, td.num_top, S), 10),
            "E7 per ray": cs.cuda_ms(lambda: lane_bottom.lane_bottom_rays(
                *e7_ray, False), 10)}
        run = {"sources": tag, "ms": ms,
               "check_s": {"E6/E7": t2 - t1, "E1": t3 - t2, "E3": t4 - t3},
               "nonfinite_equal": {"E6": e6_ok, "E7": e7_ok, "E1": e1_ok,
                                   "E3 segmin": seg_ok}}
        runs.append(run)
        print("\n".join(rows), flush=True)
        print(json.dumps(run), flush=True)
    print(smi)
    print(json.dumps({"runs": runs, "card": smi}))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
