"""The port's host plane (loupiote_tpu_torch: scene model, procedural
scene, BVH builders, wide collapse, scene tables) against the reference's.

The port copies the reference's numpy host code because importing any
loupiote_tpu module imports jax; these tests hold the copies to the
reference's tables byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import loupiote_tpu.scene.types as ref_types
import loupiote_tpu_torch.scene.types as port_types
from loupiote_tpu.accel.bvh import build_bvh as ref_build_bvh
from loupiote_tpu.accel.bvh import bvh_max_depth as ref_bvh_max_depth
from loupiote_tpu.scene import build_probe as ref_build_probe
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import build_arch_scene as port_arch
from loupiote_tpu_torch import (Renderer, build_probe, build_scene_buffers,
                                from_reference)
from loupiote_tpu_torch.accel import native
from loupiote_tpu_torch.accel.bvh import build_bvh, bvh_max_depth
from loupiote_tpu_torch.ops.wide import wide_trace_plain
from torch_port_helpers import (numpy_bvh, random_rays, random_tris,
                                sky_equirect, soup_scene, t_of, ulp_diff)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLES = ("trav_rows", "tri_shade", "mat_pack", "tri_pack", "light_origin",
          "light_eu", "light_ev", "light_emission", "node_min", "node_max",
          "atlas", "atlas_blocks", "probe", "probe_cdf_cond",
          "probe_cdf_marg", "probe_pdf")
INTS = ("wide_end", "wide_stack", "num_nodes", "leaf_cap", "num_lights",
        "has_probe", "has_textures")


def _scenes(name):
    if name == "random500":
        tris = random_tris()
        return soup_scene(ref_types, *tris), soup_scene(port_types, *tris)
    if name == "arch8k_textured":
        return (ref_arch(8_000, textured=True, props=20),
                port_arch(8_000, textured=True, props=20))
    if name == "arch8k_merged":
        kw = dict(textured=True, props=20, merged=True)
        return ref_arch(8_000, **kw), port_arch(8_000, **kw)
    return ref_arch(8_000), port_arch(8_000)


@pytest.mark.parametrize("name", ["random500", "arch8k", "arch8k_textured",
                                  "arch8k_merged"])
def test_tables_byte_equal(name):
    """Same scene, numpy BVH builder on both sides: identical tables. The
    textured hall with 20 props (flattened) carries an atlas and a probe
    built by each package from one sky; merged, the hall is one mesh
    (tests/test_golden_scenes.py's instanced scene, flattened here)."""
    ref_scene, port_scene = _scenes(name)
    ref_kw, kw = {}, {}
    if name == "arch8k_textured":
        sky = sky_equirect(256, 512)
        ref_kw, kw = ({"probe": ref_build_probe(sky)},
                      {"probe": build_probe(sky)})
    with numpy_bvh():
        ref = ref_buffers(ref_scene, **ref_kw)
    port = build_scene_buffers(port_scene, device="cpu", use_native=False,
                               **kw)
    for f in TABLES:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    for f in INTS:
        assert getattr(ref, f) == getattr(port, f), f


def test_from_reference_round_trips_every_field():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(8_000))
    port = from_reference(ref, device="cpu")
    for f in TABLES:
        t, a = getattr(port, f), np.asarray(getattr(ref, f))
        assert t.numpy().dtype == a.dtype and t.is_contiguous(), f
        assert t.numpy().tobytes() == a.tobytes(), f
    for f in INTS:
        assert getattr(port, f) == getattr(ref, f), f
    # Bitcast ints survive: material ids and -1 child pointers.
    mats = port.tri_shade.view(torch.int32)[:, 15].numpy()
    assert (mats == np.asarray(ref.tri_shade).view(np.int32)[:, 15]).all()
    ptr = port.trav_rows.view(torch.int32)[:port.wide_end, 6::16]
    assert (ptr == -1).any() and ((ptr & (1 << 30)) != 0).any()


def test_bvh_max_depth_matches_reference():
    v0, v1, v2 = random_tris(seed=11, n=777, spread=5.0, size=0.3)
    with numpy_bvh():
        ref = ref_build_bvh(v0, v1, v2)
    port = build_bvh(v0, v1, v2, use_native=False)
    assert (port.miss == ref.miss).all() and (port.count == ref.count).all()
    assert (bvh_max_depth(port.count, port.miss)
            == ref_bvh_max_depth(ref.count, ref.miss))


def test_native_builder_gives_a_valid_tree():
    """The port's C++ build (its own library, built without -march=native)
    traverses to the brute-force closest hit. Its tree may differ from the
    reference's."""
    tris = random_tris(seed=5, n=2000, spread=10.0, size=0.8)
    bufs = build_scene_buffers(soup_scene(port_types, *tris), device="cpu")
    lib = [p for p in os.listdir(native.BUILD_DIR) if p.startswith("libbvh")]
    assert lib and native.BUILD_DIR.startswith(
        os.path.join(REPO, "loupiote_tpu_torch"))
    ro, rd = random_rays(tris, 512, seed=6)
    R = len(ro)
    t, tri = wide_trace_plain(bufs.trav_rows, torch.from_numpy(ro),
                              torch.from_numpy(rd), torch.full((R,), 1e30),
                              torch.ones(R, dtype=torch.bool), False,
                              bufs.wide_end, bufs.wide_stack)
    # Brute force over every triangle, in the port's triangle order.
    tp = bufs.tri_pack.numpy()
    T = len(tris[0])
    best_t = np.full(R, np.inf, np.float32)
    for k in range(T):
        u, v, tt = t_of(tp, ro, rd, np.full(R, k))
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 1e-4)
        best_t = np.where(ok & (tt < best_t), tt, best_t)
    hit = np.isfinite(best_t)
    assert (tri.numpy() >= 0).tolist() == hit.tolist()
    assert (ulp_diff(t.numpy()[hit], best_t[hit]) == 0).all()


@pytest.mark.parametrize("name", ["random500", "arch8k"])
def test_bvh2_tables_byte_equal(name):
    """node_rows, leaf_rows, end_index and stack_depth: the port's own
    host path and from_reference give the reference's bytes."""
    ref_scene, port_scene = _scenes(name)
    with numpy_bvh():
        ref = ref_buffers(ref_scene)
    ports = (build_scene_buffers(port_scene, device="cpu",
                                 use_native=False),
             from_reference(ref, device="cpu"))
    for port in ports:
        for f in ("node_rows", "leaf_rows"):
            a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            assert a.tobytes() == b.tobytes(), f
        assert port.end_index == ref.end_index == port.num_nodes
        assert port.stack_depth == ref.stack_depth >= 64
        ints = port.node_rows.view(torch.int32)
        leaf = ints[:port.num_nodes, 6] > 0
        assert int(ints[:port.num_nodes, 8][leaf].max()) == \
            port.leaf_rows.shape[0] - 1
        # Padding rows past end_index are empty boxes.
        assert (port.node_rows[port.end_index:, :3] == 1e30).all()


def test_bvh_builder_source_is_the_references():
    """The port compiles its own copy of the C++ builder, byte-equal to
    the reference's source."""
    with open(os.path.join(REPO, "loupiote_tpu", "accel", "cpp",
                           "bvh_builder.cpp"), "rb") as f:
        ref_src = f.read()
    with open(native.SOURCE, "rb") as f:
        assert f.read() == ref_src
    assert native.SOURCE.startswith(os.path.join(REPO, "loupiote_tpu_torch"))


def test_entry_points_default_to_the_card():
    """Without a card, the entry points raise instead of falling back to
    the CPU; asked for the CPU, they run there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    scene = port_arch(2_000)
    with pytest.raises((RuntimeError, AssertionError)):
        build_scene_buffers(scene)
    with numpy_bvh():
        ref = ref_buffers(ref_arch(2_000))
    with pytest.raises((RuntimeError, AssertionError)):
        from_reference(ref)
    with pytest.raises((RuntimeError, AssertionError)):
        Renderer((16, 16))
    assert build_scene_buffers(scene, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of the port and chip_smoke.py, building a
    scene with treelet tables (which compiles or loads the native
    builder) and a probe's tables (an area resize), imports no jax,
    nothing of loupiote_tpu or experiments and no image decoder (PIL,
    imageio, cv2: the card's host has none), and opens, runs or loads no
    file under loupiote_tpu/ or experiments/."""
    code = """
import importlib, os, pkgutil, sys
ref_dirs = tuple(os.path.join(os.getcwd(), d) + os.sep
                 for d in ("loupiote_tpu", "experiments"))
seen = []

def paths(x):
    if isinstance(x, (str, bytes, os.PathLike)):
        return [os.path.abspath(os.fsdecode(x))]
    if isinstance(x, (list, tuple)):
        return [p for y in x for p in paths(y)]
    return []

def hook(event, args):
    if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.exec"):
        seen.extend(paths(args[:2]))

sys.addaudithook(hook)
import loupiote_tpu_torch as lt
for m in pkgutil.walk_packages(lt.__path__, "loupiote_tpu_torch."):
    importlib.import_module(m.name)
importlib.import_module("chip_smoke")
b = lt.build_scene_buffers(lt.build_arch_scene(2_000), device="cpu",
                           treelets=True)
assert b.treelet is not None
import numpy as np
assert lt.build_probe(np.ones((128, 300, 3), np.float32)).pdf.shape == (64, 128)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "loupiote_tpu", "experiments", "PIL",
        "imageio", "cv2")]
assert not bad, bad
opened = sorted({p for p in seen if p.startswith(ref_dirs)})
assert not opened, opened
assert any(p.endswith("bvh_builder.cpp") or "libbvh_" in p for p in seen)
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
    # No module names the reference package or experiments/ as a path
    # component.
    for root, _, files in os.walk(os.path.join(REPO, "loupiote_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as f:
                    src = f.read()
                assert '"loupiote_tpu"' not in src, fn
                assert '"experiments"' not in src, fn
