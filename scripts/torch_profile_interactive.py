#!/usr/bin/env python3
"""Device-time breakdown of one of the port's frames on one GPU.

    python3 scripts/torch_profile_interactive.py [interactive|treelet] [ROOT]

``interactive`` (the default): renders arch-40k through
``Renderer((1920, 1080), RenderConfig())`` in ``DENOISED_PATHTRACE``
(960x540 internal, A-SVGF on) with the camera moving every frame, as
``chip_smoke.py`` does, traces 5 warm frames with ``torch.profiler``, then
traces ``denoise`` alone on a frame's own inputs. ``treelet``: renders
arch-260k with ``treelets=True`` through ``Renderer((1920, 1080),
RenderConfig(downsample_factor=1.0, denoise=False))`` with ``accumulate``
on, as ``chip_smoke.py``'s treelet frame, and traces 5 warm frames.

For each trace it prints the host-clock wall time, the device-busy time
(the sum of the device's kernel, copy and fill intervals, which one stream
runs one at a time), the idle share, the device op count, the kernels that
take the most device time, and the host time spent blocked in the CUDA
runtime's synchronising calls (stream and device synchronisation,
device-to-host copies), where the host waits for the device. ``ROOT``: the
directory whose ``loupiote_tpu_torch`` is imported (default: this
repository), so that another commit's package, unpacked from a ``git
archive``, is measured by the same script. Needs CUDA; fails without it.
"""

import math
import os
import subprocess
import sys
import time

FRAME = sys.argv[1] if len(sys.argv) > 1 else "interactive"
sys.path.insert(0, os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 5
# Runtime calls in which the host waits for the device.
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def report(name, prof, wall_ms, n):
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    unit = "frame" if n > 1 else "call"
    print(f"{name}: wall {wall_ms / n:.3f} ms, device busy {busy / n:.3f} "
          f"ms, idle share {1 - busy / wall_ms:.3f}, device ops "
          f"{len(evs) / n:.0f} (per {unit}, {n} traced)")
    if not evs:
        raise SystemExit("the profiler recorded no device time")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms / n:8.3f} ms  {ms / busy:6.1%}  {k[:90]}")
    waits = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in BLOCKING:
            c, ms = waits.get(e.name, (0, 0.0))
            waits[e.name] = (c + 1, ms + e.time_range.elapsed_us() / 1e3)
    blocked = sum(ms for _, ms in waits.values())
    print(f"    host blocked in the runtime: {blocked / n:.3f} ms a {unit} "
          f"({blocked / wall_ms:.1%} of the wall time); "
          + ", ".join(f"{k} {c / n:.0f} calls {ms / n:.3f} ms"
                      for k, (c, ms) in sorted(waits.items())))


def profiled(fn, n):
    """(profile, wall ms) of ``n`` calls of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def main():
    import torch

    if FRAME not in ("interactive", "treelet"):
        raise SystemExit(f"torch_profile_interactive: unknown frame {FRAME}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_interactive: needs a CUDA device")
    import loupiote_tpu_torch as lt
    from loupiote_tpu_torch.denoise.asvgf import denoise
    from loupiote_tpu_torch.render import renderer as rmod
    from loupiote_tpu_torch.render.integrator import trace_paths

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}; package "
          f"{os.path.dirname(lt.__file__)}")
    dev = torch.device("cuda")
    view = lt.arch_camera()
    if FRAME == "interactive":
        scene = lt.build_scene_buffers(lt.build_arch_scene(40_000))
        r = lt.Renderer((1920, 1080), lt.RenderConfig())
        r.set_resources(scene)
        r.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
        step = 1e-3  # the camera moves every frame
    else:
        scene = lt.build_scene_buffers(lt.build_arch_scene(260_000),
                                       treelets=True)
        r = lt.Renderer((1920, 1080), lt.RenderConfig(downsample_factor=1.0,
                                                      denoise=False))
        r.set_resources(scene)
        r.accumulate = True
        step = 0.0

    def frame():
        view[0, 3] += step
        r.raytrace(view)

    for _ in range(3):  # warm-up: kernel builds, allocator
        frame()
    torch.cuda.synchronize()
    report(f"{FRAME} frame", *profiled(frame, FRAMES), FRAMES)
    if FRAME == "treelet":
        return

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
    report("A-SVGF alone", *profiled(lambda: denoise(*args), 1), 1)


if __name__ == "__main__":
    sys.exit(main())
