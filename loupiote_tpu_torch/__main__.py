"""CLI: render glTF scenes to PNG, fly through them, serve them to a
browser, or print their stats (counterpart of ``loupiote_tpu/__main__.py``).

Usage:
    python -m loupiote_tpu_torch render scene.glb out.png [--env probe.hdr]
        [--spp 16] [--size 1280x720] [--scale 0.5] [--bounces 3]
        [--mode pathtrace|denoised|gbuffer|motion] [--camera x,y,z,dx,dy,dz]
        [--device cuda]
    python -m loupiote_tpu_torch flythrough scene.glb outdir [--frames 60] ...
    python -m loupiote_tpu_torch serve scene.glb [--port 8722] ...
    python -m loupiote_tpu_torch info scene.glb

Frames run on the card unless ``--device`` names another torch device
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--env", help="HDR environment probe path")
    p.add_argument("--size", default="1280x720")
    p.add_argument("--scale", type=float, default=0.5,
                   help="internal resolution factor (reference default 0.5)")
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--mode", default="denoised",
                   choices=["pathtrace", "denoised", "temporal", "gbuffer",
                            "motion"])
    p.add_argument("--camera", default="-10,1,0,1,0.35,0",
                   help="x,y,z,dx,dy,dz (the reference app's default)")
    p.add_argument("--blue-noise", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fit-light", type=float, metavar="INTENSITY", default=None,
                   help="replace lights with an overhead quad sized to the "
                        "scene bounds at the given intensity")
    p.add_argument("--device", default="cuda",
                   help="torch device the frames run on (default: the card)")


def _setup(args):
    from .app import Driver
    from .config import BlitMode, RenderConfig

    w, h = (int(v) for v in args.size.split("x"))
    cfg = RenderConfig(downsample_factor=args.scale,
                       bounces_static=args.bounces,
                       bounces_moving=args.bounces)
    d = Driver(size=(w, h), config=cfg, device=args.device)
    # Every positional scene merges into one session, each optionally
    # translated, as the reference app's start-up session does.
    for entry in ([args.scene] if isinstance(args.scene, str)
                  else args.scene):
        path, _, offs = entry.partition("@")
        before = len(d.scene.instances)
        d.load_gltf_path(path)
        if offs:
            t = np.array([float(v) for v in offs.split(",")], np.float32)
            for inst in d.scene.instances[before:]:
                inst.model_to_world = inst.model_to_world.copy()
                inst.model_to_world[:3, 3] += t
    if args.env:
        d.load_env_path(args.env)
    if args.blue_noise:
        d.load_blue_noise()
        d.settings.use_blue_noise = True
    if args.fit_light is not None:
        d.scene.fit_default_light(args.fit_light)
    d.upload_scene()

    mode = {"pathtrace": BlitMode.PATHTRACE, "denoised": BlitMode.DENOISED_PATHTRACE,
            "temporal": BlitMode.TEMPORAL, "gbuffer": BlitMode.GBUFFER,
            "motion": BlitMode.MOTION_VECTOR}[args.mode]
    d.settings.blit_mode = mode

    vals = [float(v) for v in args.camera.split(",")]
    origin, direction = np.array(vals[:3], np.float32), np.array(vals[3:], np.float32)
    from .render import CameraController

    d.camera_controller = CameraController.from_origin_dir(
        origin, direction / np.linalg.norm(direction))
    return d


def _sync(d):
    import torch

    if d.renderer.device.type == "cuda":
        torch.cuda.synchronize(d.renderer.device)


def cmd_render(args):
    d = _setup(args)
    d.settings.accumulate = True
    t0 = time.perf_counter()
    for i in range(args.spp):
        if i == 1:  # the first frame builds and loads the kernels
            _sync(d)
            t0 = time.perf_counter()
        d.step(dt=1.0 / 60.0)
        print(f"\rframe {i + 1}/{args.spp} "
              f"({d.queries.frame_ms:.0f} ms)", end="", file=sys.stderr)
    _sync(d)
    ms = (time.perf_counter() - t0) * 1e3 / max(args.spp - 1, 1)
    print(file=sys.stderr)
    d.save_screenshot(args.out)
    w, h = d.renderer.get_size()
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp, mode={args.mode}; "
          f"{ms:.3f} ms a frame after the first, on "
          f"{d.renderer.device})")


def cmd_flythrough(args):
    d = _setup(args)
    vals = [float(v) for v in args.camera.split(",")]
    a = np.array(vals[:3], np.float32)
    b = a + np.array(vals[3:], np.float32) * args.distance
    d.run_flythrough([a, b], args.frames, out_dir=args.outdir)
    print(f"wrote {args.frames} frames to {args.outdir}")


def cmd_serve(args):
    from .app.server import ViewerServer

    d = _setup(args)
    d.settings.accumulate = True
    srv = ViewerServer(d, host=args.host, port=args.port)
    print(f"viewer at http://{args.host}:{srv.port}/ "
          f"(WASD/arrows move, drag rotates, space toggles accumulation)")
    srv.serve_forever()


def cmd_info(args):
    from .scene import Scene, load_gltf_path

    scene = Scene.default()
    load_gltf_path(args.scene, scene)
    print(json.dumps(scene.stats(), indent=2))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="loupiote_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    scene_help = ("glTF scene path(s); several merge into one session, "
                  "each optionally translated as path@dx,dy,dz")
    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", nargs="+", help=scene_help)
    pr.add_argument("out")
    pr.add_argument("--spp", type=int, default=16)
    _add_common(pr)
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("flythrough", help="camera fly-through frame dump")
    pf.add_argument("scene", nargs="+", help=scene_help)
    pf.add_argument("outdir")
    pf.add_argument("--frames", type=int, default=60)
    pf.add_argument("--distance", type=float, default=5.0)
    _add_common(pf)
    pf.set_defaults(fn=cmd_flythrough)

    pi = sub.add_parser("info", help="print scene stats")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("serve", help="live browser viewer (interactive "
                                      "window analog)")
    ps.add_argument("scene", nargs="+", help=scene_help)
    ps.add_argument("--port", type=int, default=8722)
    ps.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the unauthenticated viewer to the network)")
    _add_common(ps)
    ps.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
