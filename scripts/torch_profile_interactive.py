#!/usr/bin/env python3
"""Device-time breakdown of the port's interactive frame on one GPU.

    python3 scripts/torch_profile_interactive.py

Renders arch-40k through ``Renderer((1920, 1080), RenderConfig())`` in
``DENOISED_PATHTRACE`` (960x540 internal, A-SVGF on) with the camera moving
every frame, as ``chip_smoke.py`` does, and traces 5 warm frames with
``torch.profiler``; then traces ``denoise`` alone on a frame's own inputs.
For each it prints the host-clock wall time, the device-busy time (the sum
of the device's kernel, copy and fill intervals, which one stream runs
one at a time), the idle share, the kernel count and the kernels that
take the most device time. Needs CUDA; fails without it.
"""

import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FRAMES = 5


def device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def report(name, prof, wall_ms, n):
    evs = device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    print(f"{name}: wall {wall_ms / n:.3f} ms, device busy {busy / n:.3f} "
          f"ms, idle share {1 - busy / wall_ms:.3f}, device ops "
          f"{len(evs) / n:.0f} (per {'frame' if n > 1 else 'call'}, "
          f"{n} traced)")
    if not evs:
        raise SystemExit("the profiler recorded no device time")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms / n:8.3f} ms  {ms / busy:6.1%}  {k[:90]}")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_interactive: needs a CUDA device")
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch.denoise.asvgf import denoise
    from loupiote_tpu_torch.render import renderer as rmod
    from loupiote_tpu_torch.render.integrator import trace_paths

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda")
    scene = lt.build_scene_buffers(lt.build_arch_scene(40_000))
    r = lt.Renderer((1920, 1080), lt.RenderConfig())
    r.set_resources(scene)
    r.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    view = lt.arch_camera()
    for _ in range(3):  # warm-up: kernel builds, allocator
        view[0, 3] += 1e-3
        r.raytrace(view)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            view[0, 3] += 1e-3
            r.raytrace(view)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report("interactive frame", prof, wall, FRAMES)

    st = r.state
    iw, ih = r.get_size()
    view[0, 3] += 1e-3
    sample, gb = trace_paths(scene, torch.from_numpy(view).to(dev), iw, ih,
                             r.generator, bounces=3,
                             vfov=math.radians(45.0))
    motion = rmod.motion_vectors(st.prev_world_to_screen, gb, iw, ih)
    args = (sample.reshape(ih, iw, 3), gb.albedo.reshape(ih, iw, 3), motion,
            gb.normal.reshape(ih, iw, 3), gb.depth.reshape(ih, iw),
            gb.mesh_id.reshape(ih, iw), st.gb_normal, st.gb_depth,
            st.gb_mesh, st.asvgf_illum, st.asvgf_moments, st.asvgf_history)
    denoise(*args)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        denoise(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report("A-SVGF alone", prof, wall, 1)


if __name__ == "__main__":
    sys.exit(main())
