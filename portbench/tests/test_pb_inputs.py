"""The benchmark's inputs are made from the seed alone, and the hall is
the port's generator's, each face once."""

import numpy as np
import pytest
import torch

from portbench.harness import inputs


def test_box_faces_are_the_port_generators():
    from loupiote_tpu_torch.scene import procedural

    for center, size, seg in (((0, 6.0, 0), (40.0, 12.0, 80.0), 8),
                              ((12.0, 4.8, -7.2), (2.0, 9.6, 2.0), 5),
                              ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), 3)):
        v, i, uv = inputs._tessellated_box(center, size, seg)
        pv, pi, puv = procedural._tessellated_box(center, size, seg)
        per = (seg + 1) ** 2
        # The port writes faces 0-5; the copy keeps 0, 1, 2 and 4 (3 and
        # 5 repeat 2 and 4 coincidently).
        keep = np.concatenate([np.arange(f * per, (f + 1) * per)
                               for f in (0, 1, 2, 4)])
        assert np.array_equal(v.view(np.uint32), pv[keep].view(np.uint32))
        assert np.array_equal(uv, puv[keep])
        ntri = 2 * seg * seg
        faces = pi.reshape(6, ntri * 3)[[0, 1, 2, 4]]
        remap = np.full(6 * per, -1)
        remap[keep] = np.arange(len(keep))
        assert np.array_equal(i, remap[faces.reshape(-1)])


def test_hall_is_deterministic_and_sized():
    a = inputs.build_hall(260_000, textured=True, props=200)
    b = inputs.build_hall(260_000, textured=True, props=200)
    assert len(a.meshes) == len(b.meshes)
    for x, y in zip(a.meshes, b.meshes):
        assert np.array_equal(x.positions, y.positions)
    flat = sum(len(a.meshes[i.mesh_index].indices) // 3 for i in a.instances)
    assert flat == 270_274
    plain = inputs.build_hall(260_000)
    assert sum(len(m.indices) // 3 for m in plain.meshes) == 259_874


def test_glb_loads_in_the_port():
    from loupiote_tpu_torch.scene import Scene, load_gltf

    scene = inputs.build_hall(4_000, textured=True, props=4)
    got = Scene.default()
    load_gltf(inputs.scene_glb(scene), got)
    assert len(got.instances) == len(scene.instances)
    for x, y in zip(scene.images, got.images):
        assert np.array_equal(x.data, y.data)
    for ix, iy in zip(scene.instances, got.instances):
        assert np.array_equal(ix.model_to_world, iy.model_to_world)
        assert np.array_equal(scene.meshes[ix.mesh_index].positions,
                              got.meshes[iy.mesh_index].positions)


def test_hdr_round_trip():
    from loupiote_tpu_torch.scene.hdr import read_hdr as port_read
    from portbench.reference.probe import read_hdr, rgbe_to_float

    sky = inputs.sky_equirect(16, 32, seed=2**33 + 5)
    data = inputs.hdr_bytes(sky)
    from portbench.reference.probe import float_to_rgbe

    want = rgbe_to_float(float_to_rgbe(sky))
    assert np.array_equal(read_hdr(data), want)
    assert np.array_equal(port_read(data), want)
    assert np.array_equal(inputs.sky_equirect(16, 32, seed=2**33 + 5), sky)
    assert not np.array_equal(inputs.sky_equirect(16, 32, seed=7), sky)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_camera_path_is_deterministic(seed):
    spec = {"path": "loop", "center": [0.0, 3.5, 0.0], "radii": [6.0, 24.0],
            "jitter": 2.0, "waypoints": 8, "step": 0.05,
            "yaw_step_deg": 0.3, "pitch_deg": -8.0}
    a, b = inputs.CameraPath(spec, seed), inputs.CameraPath(spec, seed)
    for k in (1, 2, 50, 1000):
        for x, y in zip(a.at(k), b.at(k)):
            assert np.array_equal(x, y) and x.dtype == np.float32
    o1, _ = a.at(1)
    o2, _ = a.at(2)
    assert np.linalg.norm(o2 - o1) == pytest.approx(0.05, rel=1e-3)
    assert abs(o1[0]) < 8.5 and abs(o1[2]) < 26.5


def test_fixed_camera():
    spec = {"path": "fixed", "origin": [0.0, 5.0, 34.0],
            "direction": [0.15, -0.12, -1.0]}
    p = inputs.CameraPath(spec, 3)
    o, d = p.at(7)
    assert np.array_equal(o, [0.0, 5.0, 34.0])
    assert np.linalg.norm(d) == pytest.approx(1.0)
    assert all(np.array_equal(x, y) for x, y in zip(p.at(1), p.at(500)))


def test_png_decodes_in_the_port():
    from loupiote_tpu_torch.image_codec import decode_png

    img = np.random.default_rng(1).integers(0, 256, (9, 13, 4), np.uint8)
    assert np.array_equal(decode_png(inputs.encode_png(img)), img)


def test_uniforms_follow_the_seed():
    from portbench.reference.sampling import draw_uniforms

    g1 = torch.Generator().manual_seed(2**31 + 1)
    g2 = torch.Generator().manual_seed(2**31 + 1)
    a, b = draw_uniforms(64, 3, g1, "cpu"), draw_uniforms(64, 3, g2, "cpu")
    assert torch.equal(a.jitter, b.jitter)
