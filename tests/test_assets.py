"""Asset-layer tests: OBJ/MTL parsing, triangulation, EXR codec, scene
builder conventions (SURVEY.md §4, component C3/C5)."""

import os
import textwrap

import numpy as np
import pytest

from pathtracer.assets.obj import parse_mtl, parse_obj, triangulate
from pathtracer.utils.image import load_exr, procedural_hdr, save_exr

REF = "/root/reference"


def write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(textwrap.dedent(content))
    return str(p)


def test_parse_simple_obj(tmp_path):
    path = write(
        tmp_path,
        "tri.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vn 0 0 1
        vt 0 0
        vt 1 0
        vt 0 1
        f 1/1/1 2/2/1 3/3/1
        """,
    )
    m = parse_obj(path)
    assert len(m.vertices) == 3
    assert len(m.shapes) == 1
    tv, tn, tuv, fm = triangulate(m)
    assert tv.shape == (1, 3, 3)
    np.testing.assert_allclose(tn[0], [[0, 0, 1]] * 3)
    np.testing.assert_allclose(tuv[0], [[0, 0], [1, 0], [0, 1]])


def test_negative_indices(tmp_path):
    path = write(
        tmp_path,
        "neg.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 0 1 0
        f -3 -2 -1
        """,
    )
    tv, *_ = triangulate(parse_obj(path))
    np.testing.assert_allclose(tv[0, 1], [1, 0, 0])


def test_quad_fan_triangulation_and_skip(tmp_path):
    path = write(
        tmp_path,
        "quad.obj",
        """\
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        f 1 2 3 4
        """,
    )
    m = parse_obj(path)
    tv, *_ = triangulate(m)
    assert tv.shape[0] == 2  # fan
    tv2, *_ = triangulate(m, skip_non_triangles=True)
    assert tv2.shape[0] == 0  # reference behaviour (cpp:454-459)


def test_missing_normal_fallback(tmp_path):
    path = write(tmp_path, "nonorm.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    _, tn, _, _ = triangulate(parse_obj(path))
    np.testing.assert_allclose(tn[0], [[0, 1, 0]] * 3)  # cpp:487


def test_scale(tmp_path):
    path = write(tmp_path, "s.obj", "v 2 4 6\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    tv, *_ = triangulate(parse_obj(path), scale=0.5)
    np.testing.assert_allclose(tv[0, 0], [1, 2, 3])


def test_parse_mtl_pbr_extensions(tmp_path):
    path = write(
        tmp_path,
        "m.mtl",
        """\
        newmtl pbr
        Kd 0.1 0.2 0.3
        Ke 1 2 3
        Ns 250
        Ni 1.45
        d 0.5
        Pr 0.25
        Pm 1.0
        map_Kd albedo.png
        map_Pr rough.png
        map_Pm metal.png
        norm normal.png
        """,
    )
    mats = parse_mtl(path)
    m = mats["pbr"]
    assert m.diffuse == (0.1, 0.2, 0.3)
    assert m.emission == (1.0, 2.0, 3.0)
    assert m.roughness == 0.25
    assert m.metallic == 1.0
    assert m.dissolve == 0.5
    assert m.diffuse_texname == "albedo.png"
    assert m.normal_texname == "normal.png"


@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_reference_assets_parse():
    m = parse_obj(f"{REF}/monkey.obj")
    tv, *_ = triangulate(m)
    assert tv.shape[0] == 15744  # 7872 quads -> 2 tris each
    m2 = parse_obj(f"{REF}/suitcase.obj")
    tv2, *_ = triangulate(m2, skip_non_triangles=True)
    assert tv2.shape[0] == 2204  # SURVEY.md: 2,204 faces, all tris


def test_exr_roundtrip(tmp_path):
    img = procedural_hdr(32, 64, seed=1)
    for comp in (0, 2, 3):
        p = str(tmp_path / f"t{comp}.exr")
        save_exr(p, img, compression=comp)
        back = load_exr(p)
        np.testing.assert_array_equal(back, img)


def test_exr_compressible_roundtrip(tmp_path):
    img = np.tile(
        np.linspace(0, 10, 64, dtype=np.float32)[None, :, None], (16, 1, 3)
    )
    p = str(tmp_path / "c.exr")
    save_exr(p, img, compression=3)
    np.testing.assert_array_equal(load_exr(p), img)
    assert os.path.getsize(p) < img.nbytes // 2  # zlib path exercised


def test_exr_rejects_garbage(tmp_path):
    p = tmp_path / "bad.exr"
    p.write_bytes(b"not an exr at all")
    with pytest.raises(ValueError):
        load_exr(str(p))


def test_builder_convention_materials(tmp_path):
    # File without maps -> deterministic random material; with maps -> gray.
    obj = write(tmp_path, "thing.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    from pathtracer.scene.builder import load_scene

    s1 = load_scene([obj], rng_seed=7)
    s2 = load_scene([obj], rng_seed=7)
    np.testing.assert_array_equal(
        np.asarray(s1.materials.diffuse_color), np.asarray(s2.materials.diffuse_color)
    )
    # floor material appended (gray 0.2, roughness 0.1, cpp:601-608)
    assert s1.materials.num_materials == 2
    np.testing.assert_allclose(np.asarray(s1.materials.diffuse_color)[1], 0.2)
    np.testing.assert_allclose(np.asarray(s1.materials.roughness)[1], 0.1)
    # floor sits at the min vertex height
    floor_y = np.asarray(s1.vertices)[-2:, :, 1]
    np.testing.assert_allclose(floor_y, 0.0)


def test_builder_convention_texture_discovery(tmp_path):
    from PIL import Image

    obj = write(tmp_path, "tex.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    Image.fromarray(
        (np.ones((4, 4, 3)) * [255, 0, 0]).astype(np.uint8)
    ).save(tmp_path / "tex_albedo.png")
    from pathtracer.scene.builder import load_scene

    s = load_scene([obj])
    has = np.asarray(s.materials.has_map)
    assert has[0, 0] and not has[0, 1]  # albedo only
    np.testing.assert_allclose(np.asarray(s.materials.diffuse_color)[0], 0.5)
    pool = np.asarray(s.materials.texture_quads)
    assert pool.shape == (16, 4)  # 4x4 texels, quad-packed
    # red texel: RGBA8 word r=255, g=0, b=0
    assert pool[0, 0] & 0xFF == 255
    assert (pool[0, 0] >> 8) & 0xFFFF == 0


def test_builder_mtl_source(tmp_path):
    write(
        tmp_path,
        "m.mtl",
        "newmtl red\nKd 1 0 0\nPr 0.3\n",
    )
    obj = write(
        tmp_path,
        "withmtl.obj",
        "mtllib m.mtl\nusemtl red\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    )
    from pathtracer.scene.builder import load_scene

    s = load_scene([obj], material_source="mtl", add_floor=False)
    np.testing.assert_allclose(np.asarray(s.materials.diffuse_color)[0], [1, 0, 0])
    np.testing.assert_allclose(np.asarray(s.materials.roughness)[0], 0.3)


class TestSceneFile:
    def test_spheres_scene_file_golden(self, tmp_path):
        # The committed scene file drives a render end-to-end and matches
        # the directly-constructed equivalent bitwise (SURVEY §5 config
        # system: the reference's hard-coded block as data).
        import jax.numpy as jnp

        from pathtracer.config import RenderConfig
        from pathtracer.render.camera import Camera
        from pathtracer.render.integrator import camera_arrays, render_frame
        from pathtracer.scene.procedural import three_spheres_scene
        from pathtracer.scene.scenefile import load_scene_file

        scene, camera, cfg = load_scene_file("scenes/spheres.toml")
        assert (cfg.width, cfg.height) == (64, 48)
        assert cfg.env_mode == "sunsky" and not cfg.dof
        img = np.asarray(
            render_frame(scene, camera_arrays(camera, cfg), cfg, jnp.int32(0))
        )

        ref_cfg = RenderConfig(width=64, height=48, samples_per_launch=2,
                               max_depth=4, dof=False, env_mode="sunsky",
                               intersector="brute")
        ref_scene = three_spheres_scene()
        ref_cam = Camera(eye=(0, 2, 8), lookat=(0, 1, 0))
        ref = np.asarray(render_frame(
            ref_scene, camera_arrays(ref_cam, ref_cfg), ref_cfg, jnp.int32(0)
        ))
        np.testing.assert_array_equal(img, ref)

    def test_suitcase_scene_file_loads(self):
        import os

        if not os.path.exists("/root/reference/suitcase.obj"):
            import pytest

            pytest.skip("reference assets unavailable")
        from pathtracer.scene.scenefile import load_scene_file

        scene, camera, cfg = load_scene_file("scenes/suitcase.toml")
        assert scene.num_triangles > 2000
        assert scene.accel is not None
        assert cfg.max_depth == 20 and cfg.dof

    def test_scene_file_overrides_and_validation(self, tmp_path):
        from pathtracer.scene.scenefile import load_scene_file

        _, _, cfg = load_scene_file(
            "scenes/spheres.toml", overrides={"max_depth": 9}
        )
        assert cfg.max_depth == 9

        bad = tmp_path / "bad.toml"
        bad.write_text("[render]\nnot_a_field = 1\n")
        with pytest.raises(ValueError, match="unknown .render. fields"):
            load_scene_file(str(bad))

    def test_cli_scene_file(self, tmp_path):
        from pathtracer.cli import main

        out = str(tmp_path / "sf.png")
        rc = main(["--scene-file", "scenes/spheres.toml", "--file", out,
                   "--spp", "2"])
        assert rc == 0
        from PIL import Image

        img = np.asarray(Image.open(out))
        assert img.shape == (48, 64, 3)
