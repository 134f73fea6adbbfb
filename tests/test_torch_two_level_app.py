"""Upstream's two-level layout on the app's own path: a configuration
with ``RenderConfig(instancing=True)`` renders through ``Driver``'s
loaders, ``upload_scene``, ``step`` and ``blit`` with no side path.

Standards: the frames of a small hall (about 5,000 triangles, 30 props:
two candidate groups of 15 instances, over ``TLAS_C``) are judged exactly
(``image_rel_l1`` and ``blit_mean_abs`` 0.0) by the benchmark's plain
two-level reference (``portbench/reference/instanced.py``) in both frame
modes, and with one candidate wave a group, where the drain runs, also
with the dispatch threshold lowered so that K1 BLASes split the
instance loop into runs; ``instancing=False`` still builds the
flattened buffers; a recorded
two-level frame holds the ``tlas`` and ``blas`` spans and the counts of
visits, candidate waves, drain waves, traversals by kernel and the four
sync sites, and a flattened frame none of them; ``--instancing`` reaches
``RenderConfig`` through every subcommand that builds one.
"""

import pytest
import torch

from loupiote_tpu_torch import __main__ as cli
from loupiote_tpu_torch import spans
from loupiote_tpu_torch.app import Driver, gui
from loupiote_tpu_torch.ops import intersect as port_intersect
from loupiote_tpu_torch.scene import instanced as port_instanced
from portbench.harness import inputs, judge, program, runner
from portbench.harness.cells import find_cell
from portbench.reference import instanced as ref_instanced
from portbench.reference.session import Session as Reference

CELL = "viewer720p-instanced-flythrough-pathtrace"
SEED = 2**31 + 5
# The culled visits of a wave: the shell, 20 pillars and the floor, one
# instance a mesh; the props' two meshes are candidate groups.
CULLED = 22


def small_cell(mode: str = "pathtrace", instancing: bool = True):
    """The cell at 128 x 64 internal pixels over a 5,000-triangle hall
    with 30 props and a 64 x 128 sky, in frame mode ``mode``."""
    cell = find_cell(CELL)
    cfg = cell.config
    cfg["scene"].update(triangles=5_000, props=30,
                        sky={"height": 64, "width": 128})
    cfg["window"] = [256, 128]
    cfg["render"]["instancing"] = instancing
    cell.traffic["mode"] = mode
    return cell


def session_of(cell, seed: int = SEED):
    scene, hdr = runner.make_inputs(cell, seed)
    return program.build(cell, scene, hdr, seed, torch.device("cpu"))


@pytest.fixture
def tlas_c(request, monkeypatch):
    """``TLAS_C`` set on both sides (the program and the reference)."""
    for mod in (port_instanced, ref_instanced):
        monkeypatch.setattr(mod, "TLAS_C", request.param)
    return request.param


@pytest.mark.parametrize("mode, tlas_c", [("pathtrace", 12),
                                          ("denoised", 12),
                                          ("pathtrace", 1)],
                         indirect=["tlas_c"])
def test_driver_frames_match_the_two_level_reference(mode, tlas_c):
    cell = small_cell(mode)
    session = session_of(cell)
    assert session.driver.renderer.scene.blas is not None
    for _ in range(int(cell.traffic["warmup_frames"])):
        session.captured_frame()
    warm = list(session.captures)
    session.captures.clear()
    with spans.recording() as rec:
        session.captured_frame()
    window = list(session.captures)
    if tlas_c == 1:
        assert rec.counts.get(("tlas", "drain"), 0) > 0
    scene, hdr = runner.make_inputs(cell, SEED)
    ref = Reference(scene, hdr, cell.config, mode, False, SEED, "cpu",
                    float(cell.traffic["dt"]))
    out = judge.judge(ref, warm, window,
                      inputs.CameraPath(cell.traffic["camera"], SEED))
    assert out["worst"] == {"image_rel_l1": 0.0, "blit_mean_abs": 0.0}, \
        out["frames"]


@pytest.mark.parametrize("mode, tlas_c", [("pathtrace", 12),
                                          ("denoised", 1)],
                         indirect=["tlas_c"])
def test_runs_split_at_k1_blases_match_the_reference(mode, tlas_c,
                                                     monkeypatch):
    """With the dispatch threshold at 40 BVH2 nodes on both sides the
    larger BLASes take K1 and split the instance loop into runs: the loop
    runs them one after another, the carry passed from run to run (on the
    card the K2 runs are the two-level kernel's launches), and the frames
    are still the reference's exactly, with the drain at TLAS_C 1."""
    monkeypatch.setattr(port_intersect, "_WIDE_MIN_NODES", 40)
    monkeypatch.setattr(ref_instanced, "WIDE_MIN_NODES", 40)
    cell = small_cell(mode)
    session = session_of(cell)
    bufs = session.driver.renderer.scene
    runs = port_instanced.plan_runs(
        bufs.tlas.groups, [port_intersect.uses_bvh2(b) for b in bufs.blas])
    assert len(runs) >= 3 and {r[2] for r in runs} == {False, True}
    for _ in range(int(cell.traffic["warmup_frames"])):
        session.captured_frame()
    warm = list(session.captures)
    session.captures.clear()
    with spans.recording() as rec:
        session.captured_frame()
    window = list(session.captures)
    assert rec.counts[("tlas_path", "plain")] == len(
        [s for s in rec.spans if s.name == "tlas"])
    if tlas_c == 1:
        assert rec.counts.get(("tlas", "drain"), 0) > 0
    scene, hdr = runner.make_inputs(cell, SEED)
    ref = Reference(scene, hdr, cell.config, mode, False, SEED, "cpu",
                    float(cell.traffic["dt"]))
    out = judge.judge(ref, warm, window,
                      inputs.CameraPath(cell.traffic["camera"], SEED))
    assert out["worst"] == {"image_rel_l1": 0.0, "blit_mean_abs": 0.0}, \
        out["frames"]


@pytest.mark.parametrize("instancing", [False, True])
def test_upload_scene_follows_render_config(instancing):
    d = session_of(small_cell(instancing=instancing)).driver
    bufs, stats = d.renderer.scene, d.stats
    assert d.renderer.config.instancing is instancing
    assert stats["bvh_nodes"] == bufs.num_nodes
    status = gui.render_status(d)
    if not instancing:
        assert bufs.blas is None and bufs.inst_w2o is None
        assert bufs.num_nodes > 1 and "blas" not in stats
        assert "two-level" not in status
        return
    assert bufs.num_nodes == 1  # the shell: no bounce sort
    assert stats["instances"] == 52 and stats["blas"] == 24
    assert (stats["blas_k1"], stats["blas_k2"]) == (0, 24)
    assert stats["blas_nodes"] == sum(b.num_nodes for b in bufs.blas)
    assert "two-level: 24 BLASes (0 on K1, 24 on K2)" in status


def _record_frame(d):
    with spans.recording() as rec:
        d.step(dt=1 / 60)
        d.renderer.blit()
    return rec


@pytest.mark.parametrize("wide_min_nodes, tlas_c",
                         [(8192, 12), (8192, 1), (40, 12)],
                         indirect=["tlas_c"])
def test_two_level_frame_spans_and_counts(wide_min_nodes, tlas_c,
                                          monkeypatch):
    """At 8,192 nodes no BLAS passes the dispatch threshold (K2 alone);
    at 40 the larger BLASes take K1."""
    monkeypatch.setattr(port_intersect, "_WIDE_MIN_NODES", wide_min_nodes)
    session = session_of(small_cell())
    rec = _record_frame(session.driver)
    c = rec.counts
    paths = [rec.path(i) for i in range(len(rec.spans))]
    tlas = [p for p in paths if p[-1] == "tlas"]
    blas = [p for p in paths if p[-1] == "blas"]
    assert tlas and blas
    assert all(p[-2] == "shadow" or p[-2].startswith("intersect")
               for p in tlas)
    assert all(p[-2] == "tlas" for p in blas)
    waves = len(tlas)  # closest-hit and shadow waves alike
    visits, cands = c[("tlas", "visit")], c[("tlas", "wave")]
    drains = c.get(("tlas", "drain"), 0)
    assert visits == CULLED * waves
    # Every group that ran (some ray came near it) checked for the drain
    # once: 15 instances a group, over TLAS_C.
    assert cands == tlas_c * c[("sync", "tlas_pending")]
    assert drains == c.get(("sync", "tlas_drain"), 0)
    assert (drains > 0) == (tlas_c == 1)
    assert c[("sync", "tlas_ids")] == c[("sync", "tlas_gather")] == 2 * waves
    k1, k2 = c.get(("blas", "k1"), 0), c.get(("blas", "k2"), 0)
    assert k1 + k2 == visits + cands + drains == len(blas)
    blases = session.driver.renderer.scene.blas
    on_k1 = sum(not port_intersect.uses_bvh2(b) for b in blases)
    assert session.driver.stats["blas_k1"] == on_k1
    if wide_min_nodes == 8192:
        assert k1 == 0 and on_k1 == 0
    else:
        assert k1 > 0 and 0 < on_k1 < len(blases)
    assert rec.total("sync") == 6 + sum(
        v for (n, k), v in c.items() if n == "sync" and k.startswith("tlas"))


def test_flattened_frame_records_no_tlas():
    session = session_of(small_cell(instancing=False))
    rec = _record_frame(session.driver)
    assert not {"tlas", "blas"} & {s.name for s in rec.spans}
    assert not [k for k in rec.counts if k[0] in ("tlas", "blas")
                or k[1].startswith("tlas")]
    assert rec.total("sync") == 6


class _Built(Exception):
    def __init__(self, driver):
        super().__init__()
        self.driver = driver


@pytest.fixture(scope="module")
def hall_glb(tmp_path_factory):
    cfg = small_cell().config["scene"]
    path = tmp_path_factory.mktemp("two_level") / "hall.glb"
    path.write_bytes(inputs.scene_glb(inputs.build_hall(
        triangles=cfg["triangles"], layout_seed=cfg["layout_seed"],
        textured=cfg["textured"], props=cfg["props"])))
    return str(path)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("cmd", ["render", "flythrough", "serve"])
def test_cli_instancing_flag_reaches_render_config(cmd, flag, hall_glb,
                                                   tmp_path, monkeypatch):
    """Each subcommand that builds a ``RenderConfig`` (``serve`` is the
    viewer server's) takes ``--instancing``; the command is stopped once
    its scene is uploaded."""
    real = Driver.upload_scene

    def upload(self):
        real(self)
        raise _Built(self)

    monkeypatch.setattr(Driver, "upload_scene", upload)
    argv = {"render": ["render", hall_glb, str(tmp_path / "r.png")],
            "flythrough": ["flythrough", hall_glb, str(tmp_path / "fly")],
            "serve": ["serve", hall_glb]}[cmd]
    argv += ["--size", "32x16", "--device", "cpu"]
    if flag:
        argv.append("--instancing")
    with pytest.raises(_Built) as got:
        cli.main(argv)
    d = got.value.driver
    assert d.renderer.config.instancing is flag
    assert (d.renderer.scene.blas is not None) is flag
    assert ("blas" in d.stats) is flag
