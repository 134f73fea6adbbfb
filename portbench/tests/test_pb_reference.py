"""The reference works out the program's tables again from the
benchmark's inputs: the same wide table (so its closest hits break ties
as the program's traversal does), the same triangles, atlas, lights and
probe tables."""

import copy

import pytest
import torch

from portbench.harness import inputs, runner


@pytest.mark.parametrize("kw", [dict(), dict(textured=True, props=20)],
                         ids=["plain", "textured-props"])
def test_tables_match_the_programs(kw):
    from loupiote_tpu_torch.scene import Scene, build_scene_buffers, load_gltf
    from loupiote_tpu_torch.scene.hdr import build_probe as port_probe
    from loupiote_tpu_torch.scene.hdr import read_hdr as port_read
    from portbench.reference.probe import build_probe, read_hdr
    from portbench.reference.tables import build_tables

    scene = inputs.build_hall(100_000, **kw)
    hdr = inputs.hdr_bytes(inputs.sky_equirect(64, 128, 2**31 + 3))
    prog = Scene.default()
    load_gltf(inputs.scene_glb(scene), prog)
    prog.fit_default_light(10.0)
    pb = build_scene_buffers(prog, probe=port_probe(port_read(hdr)),
                             device="cpu")
    ref_scene = copy.copy(scene)
    ref_scene.lights = list(scene.lights)
    ref_scene.fit_default_light(10.0)
    rt = build_tables(ref_scene, probe=build_probe(read_hdr(hdr)),
                      device="cpu")
    for name in ("trav_rows", "tri_pack", "atlas", "atlas_blocks",
                 "light_origin", "light_eu", "light_ev", "light_emission",
                 "probe", "probe_cdf_cond", "probe_cdf_marg", "probe_pdf"):
        a, b = getattr(pb, name), getattr(rt, name)
        assert a.shape == b.shape and torch.equal(
            a.view(torch.uint8) if a.dtype != torch.uint8 else a,
            b.view(torch.uint8) if b.dtype != torch.uint8 else b), name
    assert torch.equal(pb.node_min[:1], rt.node_min)
    assert (pb.wide_end, pb.wide_stack, pb.num_nodes) == (
        rt.wide_end, rt.wide_stack, rt.num_nodes)
    # Shading rows: the same normals, UVs and geometric normal a triangle
    # (the material ids differ by the loader's default material).
    cols = list(range(15)) + [16, 17, 18, 19]
    assert torch.equal(pb.tri_shade[:, cols].view(torch.int32),
                       rt.tri_shade[:, cols].view(torch.int32))
    assert runner.flat_triangles(scene) == rt.num_tris
