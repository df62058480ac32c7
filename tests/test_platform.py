"""What the program needs from its platform: the pytree dataclasses, the
GPU route selection, f32 contraction precision, the compile-cache
location, no optional packages on the main path, and chip_smoke.py's
refusal to run without a GPU."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel import cluster
from pathtracer.accel.build import build_accel
from pathtracer.config import RenderConfig
from pathtracer.ops import intersect as isect
from pathtracer.render.camera import Camera
from pathtracer.render.integrator import camera_arrays, render_frame
from pathtracer.scene.procedural import three_spheres_scene
from pathtracer.utils import pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree.dataclass
class _Pair:
    a: jnp.ndarray
    b: object = None
    tag: int = pytree.field(static=True, default=3)


def test_pytree_dataclass_flatten_and_static():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(3))
    leaves, tree = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                       # static tag is not a leaf
    q = jax.tree_util.tree_unflatten(tree, [x + 1 for x in leaves])
    assert q.tag == 3 and float(q.b.sum()) == 3.0
    # None children are empty subtrees, as in the Scene's optional fields
    assert len(jax.tree_util.tree_leaves(_Pair(a=jnp.ones(1)))) == 1


def test_pytree_dataclass_replace_and_frozen():
    p = _Pair(a=jnp.ones(2))
    r = p.replace(tag=5)
    assert r.tag == 5 and p.tag == 3 and r.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.tag = 1


def test_pytree_static_field_is_jit_static():
    @jax.jit
    def f(p):
        return p.a * p.tag                        # python int, not a tracer

    np.testing.assert_allclose(f(_Pair(a=jnp.ones(2), tag=4)), [4.0, 4.0])


@pytest.fixture(scope="module")
def scenes():
    small = three_spheres_scene(stacks=6, slices=12)
    return small, build_accel(small, kind="cluster", cluster_size=64)


def test_route_selection_follows_backend(scenes, monkeypatch):
    """On "gpu" the cluster accel calls the Triton kernels (no fallback);
    elsewhere it runs the XLA scan.  auto prefers the accel for small
    scenes only where the kernel runs."""
    from pathtracer.ops import intersect_pallas as ip

    _, acc_scene = scenes
    acc = acc_scene.accel
    cfg = RenderConfig(intersector="cluster")
    calls = []

    def spy(*a, **kw):
        calls.append(kw)
        n = a[3].shape[0]
        return (jnp.full((n,), 1e16), jnp.full((n,), 0x7FFFFFFF, jnp.int32),
                jnp.zeros((n, 2)))

    monkeypatch.setattr(ip, "intersect_clusters", spy)
    o = jnp.zeros((4, 3))
    d = jnp.ones((4, 3))
    acc.intersect(acc_scene.vertices, o, d, 0.01, 1e16, cfg)
    assert not calls and not cluster.use_kernel()
    assert not isect._auto_prefers_accel(acc_scene, RenderConfig())

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cluster.use_kernel()
    hit = acc.intersect(acc_scene.vertices, o, d, 0.01, 1e16, cfg)
    assert len(calls) == 1 and not bool(hit.hit.any())
    assert calls[0]["rays_per_tile"] == (
        cluster.KERNEL_SHAPES["closest"]["rays_per_tile"])
    assert isect._auto_prefers_accel(acc_scene, RenderConfig())


def _dot_precisions(jaxpr):
    """(dtype, precision) of every dot_general in a closed jaxpr, nested
    jaxprs included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append((eqn.invars[0].aval.dtype, eqn.params["precision"]))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _f32_default_dots(jaxpr):
    bad = []
    for dtype, prec in _dot_precisions(jaxpr):
        if dtype != jnp.float32:
            continue
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        if not all(p == jax.lax.Precision.HIGHEST for p in precs):
            bad.append(prec)
    return bad


@pytest.mark.parametrize("route", ["brute", "cluster-xla", "cluster-kernel"])
def test_no_default_precision_f32_contraction(scenes, route, monkeypatch):
    """No f32 contraction on the render path runs at default precision
    (which a GPU may execute as TF32).  Walks render_frame's jaxpr with
    NEE on, for the brute route, the XLA cluster route and the kernel
    route (traced as on the GPU)."""
    from pathtracer.render.envmap import with_importance_sampling
    from pathtracer.scene.scene import make_env
    from pathtracer.utils.image import procedural_hdr

    small, acc_scene = scenes
    scene = small if route == "brute" else acc_scene
    scene = scene.replace(env=with_importance_sampling(
        make_env(procedural_hdr(16, 32))))
    if route == "cluster-kernel":
        monkeypatch.setattr(cluster, "use_kernel", lambda: True)
    cfg = RenderConfig(width=16, height=8, samples_per_launch=2, max_depth=2,
                       env_importance_sampling=True, rr_mode="standard",
                       intersector="brute" if route == "brute" else "cluster")
    cam = camera_arrays(Camera(), cfg)
    jaxpr = jax.make_jaxpr(render_frame, static_argnums=(2,))(
        scene, cam, cfg, jnp.int32(0))
    assert _f32_default_dots(jaxpr) == []


def test_precision_walk_detects_default_dot():
    jaxpr = jax.make_jaxpr(lambda a, b: a @ b)(jnp.ones((4, 4)), jnp.ones(4))
    assert _f32_default_dots(jaxpr)
    jaxpr = jax.make_jaxpr(
        lambda a, b: jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
    )(jnp.ones((4, 4)), jnp.ones(4))
    assert not _f32_default_dots(jaxpr)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from pathtracer.utils import logging as plog

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plog.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from pathtracer.utils import logging as plog

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert plog.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


_NO_OPTIONAL = """
import sys
sys.modules["flax"] = None
sys.modules["PIL"] = None
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
from pathtracer import cli
from pathtracer.utils.image import load_png
out = sys.argv[1]
assert cli.main(["--file", out, "--dim=16x12", "--launch-samples", "2",
                 "--max-depth", "2", "--no-dof", "--verbosity", "1"]) == 0
img = load_png(out)
assert img.shape == (12, 16, 3) and img.max() > 0
assert "flax" not in sys.modules or sys.modules["flax"] is None
print("ok")
"""


def test_main_path_without_flax_or_pillow(tmp_path):
    """A CLI render (scene build, render, PNG write) with flax and PIL made
    unimportable."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    r = subprocess.run(
        [sys.executable, "-c", _NO_OPTIONAL, str(tmp_path / "o.png")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails before printing a result."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
