"""Native C++ OBJ parser vs the pure-Python oracle (component C3)."""

import os
import textwrap

import numpy as np
import pytest

from pathtracer.assets.native import get_lib, parse_obj_native
from pathtracer.assets.obj import parse_obj, triangulate

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native toolchain unavailable"
)


@pytest.mark.parametrize("name", ["monkey", "suitcase", "tower", "fish", "test"])
@pytest.mark.skipif(not os.path.exists(REF), reason="reference assets absent")
def test_native_bit_identical(name):
    path = f"{REF}/{name}.obj"
    tv, tn, tuv, tm, names, libs = parse_obj_native(path, scale=0.5)
    pv, pn, puv, pm = triangulate(parse_obj(path), scale=0.5)
    np.testing.assert_array_equal(tv, pv)
    np.testing.assert_array_equal(tn, pn)
    np.testing.assert_array_equal(tuv, puv)


def test_native_negative_indices_and_quads(tmp_path):
    p = tmp_path / "q.obj"
    p.write_text(
        textwrap.dedent(
            """\
            v 0 0 0
            v 1 0 0
            v 1 1 0
            v 0 1 0
            f -4 -3 -2 -1
            """
        )
    )
    tv, *_ = parse_obj_native(str(p))
    assert tv.shape[0] == 2  # fan-triangulated quad
    tv2, *_ = parse_obj_native(str(p), skip_non_triangles=True)
    assert tv2.shape[0] == 0  # reference skip behaviour


def test_native_usemtl_grouping(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(
        textwrap.dedent(
            """\
            mtllib x.mtl
            v 0 0 0
            v 1 0 0
            v 0 1 0
            usemtl a
            f 1 2 3
            usemtl b
            f 1 2 3
            usemtl a
            f 1 2 3
            """
        )
    )
    tv, tn, tuv, tm, names, libs = parse_obj_native(str(p))
    assert names == ["a", "b"]
    assert libs == ["x.mtl"]
    np.testing.assert_array_equal(tm, [0, 1, 0])


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        parse_obj_native("/nonexistent/file.obj")


@pytest.mark.slow
def test_builder_native_matches_python(tmp_path):
    from pathtracer.scene.builder import load_scene

    if not os.path.exists(REF):
        pytest.skip("reference assets absent")
    a = load_scene([f"{REF}/suitcase.obj"], scale=0.05, rng_seed=3, use_native=True)
    b = load_scene([f"{REF}/suitcase.obj"], scale=0.05, rng_seed=3, use_native=False)
    np.testing.assert_array_equal(np.asarray(a.vertices), np.asarray(b.vertices))
    np.testing.assert_array_equal(np.asarray(a.tri_attrs), np.asarray(b.tri_attrs))
