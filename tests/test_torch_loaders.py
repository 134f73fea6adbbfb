"""The port's loaders (loupiote_tpu_torch/scene/{gltf,binary,blue_noise}.py)
and scene helpers against the reference's, on the same bytes.

The reference decodes glTF images with PIL, the port with its own PNG
and JPEG decoders (image_codec). Standards: every array of the loaded
Scene exactly equal (positions, normals, texcoords, indices, transforms,
material fields), texels byte-equal, JPEG textures included. A
progressive JPEG texture loads in the reference and raises GltfError in
the port, with the port's scene left as it was.
"""

import base64
import io
import json
import struct

import numpy as np
import pytest
from PIL import Image

import loupiote_tpu.scene as ref_scene
import loupiote_tpu.scene.types as ref_types
from loupiote_tpu.scene.blue_noise import load_noise_png as ref_noise_png
from loupiote_tpu_torch import scene as port_scene
from loupiote_tpu_torch.image_codec import encode_png
from loupiote_tpu_torch.scene import types as port_types
from loupiote_tpu_torch.scene.blue_noise import load_noise_png
from loupiote_tpu_torch.scene.fixtures import scene_glb, write_glb


def assert_scenes_equal(ref, port):
    assert ref.stats() == port.stats()
    for a, b in zip(ref.meshes, port.meshes):
        for f in ("positions", "normals", "texcoords", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert x.tobytes() == y.tobytes(), f
    for a, b in zip(ref.instances, port.instances):
        assert a.mesh_index == b.mesh_index
        assert a.material_index == b.material_index
        assert a.model_to_world.tobytes() == b.model_to_world.tobytes()
    for a, b in zip(ref.materials, port.materials):
        assert a.color.tobytes() == b.color.tobytes()
        assert a.emission.tobytes() == b.emission.tobytes()
        for f in ("roughness", "reflectivity", "albedo_texture",
                  "mra_texture"):
            assert getattr(a, f) == getattr(b, f), f
    for a, b in zip(ref.images, port.images):
        assert (a.width, a.height) == (b.width, b.height)
        assert a.data.dtype == b.data.dtype == np.uint8
        assert a.data.tobytes() == b.data.tobytes()
    for a, b in zip(ref.lights, port.lights):
        for f in ("origin", "edge_u", "edge_v", "emission"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert a.intensity == b.intensity


def load_both(data, base_dir=None):
    ref = ref_types.Scene.default()
    ref_scene.load_gltf(data, ref, base_dir=base_dir)
    port = port_types.Scene.default()
    port_scene.load_gltf(data, port, base_dir=base_dir)
    return ref, port


def test_glb_of_the_textured_hall_matches_reference():
    """The textured arch hall with props, written as a GLB with PNG
    textures (scene/fixtures.py), loads the same in both packages, and
    gives the in-memory scene back."""
    hall = port_scene.build_arch_scene(8_000, textured=True, props=12)
    data = scene_glb(hall)
    ref, port = load_both(data)
    assert_scenes_equal(ref, port)
    assert len(port.images) == 6 and port.images[0].data.shape[2] == 4
    for a, b in zip(port.meshes, hall.meshes):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.texcoords, b.texcoords)
    for a, b in zip(port.images, hall.images):
        assert np.array_equal(a.data, b.data)
    assert [i.material_index - 1 for i in port.instances] == [
        i.material_index for i in hall.instances]


def _png(rng, h, w, mode):
    c = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
    arr = rng.integers(0, 256, (h, w, c), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr.squeeze() if c == 1 else arr, mode).save(buf, "PNG")
    return buf.getvalue()


def test_jpeg_glb_of_the_textured_hall_matches_reference():
    """The same hall with its textures written as JPEG by the port's
    encode_jpeg (4:2:0, the procedural images of 128 x 128 texels): PIL
    in the reference and decode_jpeg in the port give the same texels."""
    hall = port_scene.build_arch_scene(8_000, textured=True, props=12)
    ref, port = load_both(scene_glb(hall, image_format="jpeg"))
    assert len(port.images) == len(hall.images) > 0
    assert_scenes_equal(ref, port)


def _gltf_doc(rng, image_bytes, image_mime="image/png"):
    """A JSON glTF with data URIs: an indexed triangle list with normals
    and interleaved uint8-normalized texcoords, a strip and a fan, a
    non-indexed primitive, node TRS / matrix transforms, two materials
    with base-colour and metallic-roughness textures."""
    bin_parts, views, accessors = [], [], []

    def add(arr, comp, kind, stride=None, **extra):
        off = sum(len(p) for p in bin_parts)
        data = arr.tobytes()
        data += b"\0" * (-len(data) % 4)
        bin_parts.append(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes}
        if stride:
            view["byteStride"] = stride
        views.append(view)
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": comp, "count": len(arr),
                          "type": kind, **extra})
        return len(accessors) - 1

    pos = rng.random((6, 3)).astype(np.float32)
    nrm = rng.random((6, 3)).astype(np.float32)
    p0 = add(pos, 5126, "VEC3")
    n0 = add(nrm, 5126, "VEC3")
    # uint8 texcoords, normalized, 4 bytes a vertex (2 of padding).
    uv8 = np.zeros((6, 4), np.uint8)
    uv8[:, :2] = rng.integers(0, 256, (6, 2))
    off = sum(len(p) for p in bin_parts)
    bin_parts.append(uv8.tobytes())
    views.append({"buffer": 0, "byteOffset": off, "byteLength": uv8.nbytes,
                  "byteStride": 4})
    accessors.append({"bufferView": len(views) - 1, "componentType": 5121,
                      "count": 6, "type": "VEC2", "normalized": True})
    t0 = len(accessors) - 1
    i0 = add(np.array([0, 1, 2, 3, 4, 5], np.uint16), 5123, "SCALAR")
    strip = add(np.array([0, 1, 2, 3, 4, 5], np.uint32), 5125, "SCALAR")
    blob = b"".join(bin_parts)
    buffers = [{"byteLength": len(blob), "uri": "data:application/"
                "octet-stream;base64," + base64.b64encode(blob).decode()}]
    images = [{"uri": f"data:{image_mime};base64,"
               + base64.b64encode(b).decode()} for b in image_bytes]
    q = np.array([0.1, 0.7, -0.3, 0.5])
    q /= np.linalg.norm(q)
    return {
        "asset": {"version": "2.0"}, "buffers": buffers,
        "bufferViews": views, "accessors": accessors,
        "images": images,
        "textures": [{"source": i} for i in range(len(images))][::-1],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
                "metallicFactor": 0.25, "roughnessFactor": 0.75,
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
             "emissiveFactor": [0.5, 0.0, 0.1]},
            {"pbrMetallicRoughness": {}}],
        "meshes": [
            {"primitives": [
                {"attributes": {"POSITION": p0, "NORMAL": n0,
                                "TEXCOORD_0": t0},
                 "indices": i0, "material": 0},
                {"attributes": {"POSITION": p0}, "indices": strip,
                 "mode": 5, "material": 1},
                {"attributes": {"POSITION": p0}, "indices": strip,
                 "mode": 6},
                {"attributes": {"POSITION": p0}, "mode": 4},
                {"attributes": {"POSITION": p0}, "mode": 1}]}],
        "nodes": [
            {"mesh": 0, "translation": [1, 2, 3],
             "rotation": [float(x) for x in q], "scale": [2, 0.5, 1.5]},
            {"mesh": 0, "matrix": [float(x) for x in
                                   rng.random(16).astype(np.float32)]},
            {"children": [0]}],
        "scenes": [{"nodes": [0, 1, 2]}],
    }


def test_gltf_json_with_data_uris_matches_reference():
    rng = np.random.default_rng(3)
    imgs = [_png(rng, 5, 7, "RGBA"), _png(rng, 9, 4, "RGB"),
            _png(rng, 3, 3, "L")]
    data = json.dumps(_gltf_doc(rng, imgs)).encode()
    ref, port = load_both(data)
    assert_scenes_equal(ref, port)
    assert len(port.meshes) == 4 and len(port.instances) == 8
    assert len(port.images) == 3
    assert port.materials[1].albedo_texture == 2  # textures listed reversed


def test_gltf_external_buffer_and_glb_path(tmp_path):
    """An external .bin and .png beside a .gltf, and a .glb on disk,
    through load_gltf_path."""
    rng = np.random.default_rng(4)
    doc = _gltf_doc(rng, [_png(rng, 4, 6, "RGBA")])
    blob = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    (tmp_path / "mesh.bin").write_bytes(blob)
    doc["buffers"][0]["uri"] = "mesh.bin"
    (tmp_path / "tex.png").write_bytes(
        base64.b64decode(doc["images"][0]["uri"].split(",", 1)[1]))
    doc["images"][0]["uri"] = "tex.png"
    for t in doc["materials"][0]["pbrMetallicRoughness"].values():
        if isinstance(t, dict):
            t["index"] = 0
    doc["textures"] = [{"source": 0}]
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(doc))
    glb = tmp_path / "hall.glb"
    write_glb(port_scene.build_arch_scene(2_000, textured=True), str(glb))
    for p in (path, glb):
        ref = ref_types.Scene.default()
        ref_scene.load_gltf_path(str(p), ref)
        port = port_types.Scene.default()
        port_scene.load_gltf_path(str(p), port)
        assert_scenes_equal(ref, port)


def test_jpeg_texture_raises_in_the_port():
    """JPEG textures load in the port as in the reference: baseline files
    at 4:2:0 (an odd size, restart markers) and 4:4:4, and a greyscale
    one, texels byte-equal to PIL's. A progressive JPEG, which the port
    does not decode, raises GltfError naming the image, with the port's
    scene unchanged; the reference (PIL) loads it."""
    rng = np.random.default_rng(5)

    def jpeg(shape, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).convert(
            mode).save(buf, "JPEG", **kw)
        return buf.getvalue()

    def doc_of(images):
        doc = _gltf_doc(rng, images, "image/jpeg")
        doc["images"][0]["name"] = "albedo"
        for t in doc["materials"][0]["pbrMetallicRoughness"].values():
            if isinstance(t, dict):
                t["index"] = 0
        doc["textures"] = [{"source": 0}]
        return json.dumps(doc).encode()

    baseline = [jpeg((13, 21, 3), "RGB", subsampling=2,
                     restart_marker_blocks=2),
                jpeg((8, 8, 3), "RGB", subsampling=0),
                jpeg((9, 6, 3), "L")]
    ref, port = load_both(doc_of(baseline))
    assert len(port.images) == 3
    assert_scenes_equal(ref, port)

    data = doc_of([jpeg((8, 8, 3), "RGB", progressive=True)])
    ref = ref_types.Scene.default()
    ref_scene.load_gltf(data, ref)
    assert len(ref.images) == 1
    port = port_types.Scene.default()
    before = port.stats()
    with pytest.raises(port_scene.GltfError,
                       match="image 0.*albedo.*progressive"):
        port_scene.load_gltf(data, port)
    assert port.stats() == before
    assert issubclass(port_scene.GltfError, ValueError)


def test_glb_errors_match_reference():
    for bad in (b"glTF" + struct.pack("<II", 3, 12),
                struct.pack("<III", 0x46546C67, 2, 12)):
        for mod in (ref_scene, port_scene):
            scene = mod.Scene.default()
            with pytest.raises(mod.GltfError):
                mod.load_gltf(bad, scene)


def test_binary_loader_matches_reference(tmp_path):
    rng = np.random.default_rng(6)
    tris = rng.random((7, 3, 4)).astype(np.float32)
    tris[3, 1, :3] = tris[3, 0, :3]  # a degenerate triangle
    blob = struct.pack("<I", 7) + tris.tobytes()
    ref = ref_types.Scene.default()
    ref_scene.load_binary(blob, ref)
    port = port_types.Scene.default()
    port_scene.load_binary(blob, port)
    assert_scenes_equal(ref, port)
    path = tmp_path / "mesh.bin"
    path.write_bytes(blob)
    again = port_types.Scene.default()
    port_scene.load_binary_from_path(str(path), again)
    assert_scenes_equal(port, again)


def test_noise_png_matches_reference(tmp_path):
    noise = port_scene.generate_blue_noise(16)
    path = tmp_path / "noise.png"
    path.write_bytes(encode_png(noise))
    got = load_noise_png(str(path))
    assert got.tobytes() == ref_noise_png(str(path)).tobytes()
    assert np.array_equal(got, noise)
    rgb = tmp_path / "noise_rgb.png"
    Image.fromarray(noise[..., :3]).save(rgb)
    assert load_noise_png(str(rgb)).tobytes() == ref_noise_png(
        str(rgb)).tobytes()


def test_scene_bounds_and_fitted_light_match_reference():
    rng = np.random.default_rng(8)
    imgs = [_png(rng, 2, 2, "RGBA")]
    data = json.dumps(_gltf_doc(rng, imgs)).encode()
    ref, port = load_both(data)
    for a, b in zip(ref.bounds(), port.bounds()):
        assert a.tobytes() == b.tobytes()
    ref.fit_default_light(7.5)
    port.fit_default_light(7.5)
    assert_scenes_equal(ref, port)
    empty_ref, empty_port = ref_types.Scene(), port_types.Scene()
    for a, b in zip(empty_ref.bounds(), empty_port.bounds()):
        assert a.tobytes() == b.tobytes()
    empty_ref.add_default_light_if_empty()
    empty_port.add_default_light_if_empty()
    assert len(empty_port.lights) == 1
    assert_scenes_equal(empty_ref, empty_port)
    a = ref_types.Light.fit_to_scene([0, 0, 0], [2, 4, 6], 3.0)
    b = port_types.Light.fit_to_scene([0, 0, 0], [2, 4, 6], 3.0)
    assert a.origin.tobytes() == b.origin.tobytes()
    assert a.edge_v.tobytes() == b.edge_v.tobytes()
