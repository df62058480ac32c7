"""GPU measurements behind the kernel decisions recorded in PERF.md.

Phases (--phases, comma separated):
  kernels  traversal at 131,072 rays: Triton kernel launch shapes
           (rays per packet, triangles per slice, warps, two-level walk);
           with "baselines" also the XLA cluster scan and brute force on
           the same rays;
  e2e      render_frame at 1920x1080, 10 spp, depth 8 through the kernel:
           packet size and sorting on the hero-sized scene, flat vs
           two-level walk on the 100k scene;
  e2e_baselines  the same renders through brute force and the XLA
           cluster scan (slow: tens of seconds per 100k-scene launch);
  ops      one-hot row lookup vs plain gather, triangular-matmul prefix
           sum vs jnp.cumsum, at 131,072 lanes;
  trace    one profiled launch of each scene's render: device busy time
           per schedule iteration, idle share and the top device ops.

Every line printed is one JSON object; the first names the card.  Needs a
GPU; exits non-zero elsewhere.

Usage: python tools/measure_gpu.py --phases kernels,e2e [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (scene and ray generators)

RAYS = 131_072


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def timed(fn, *args, reps: int = 10):
    """(compile+first seconds, median seconds, min seconds) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), float(np.min(ts))


# (rays per packet, triangles per slice, warps, two-level branch)
KERNEL_VARIANTS = {
    "closest": [(32, 16, 4, 8), (16, 16, 4, 8), (16, 16, 2, 8),
                (16, 32, 4, 8), (32, 16, 4, 0), (16, 16, 4, 0)],
    "any": [(128, 16, 4, 8), (64, 32, 4, 8)],
}


def phase_kernels(hero, field, baselines: bool) -> None:
    import jax

    from pathtracer.config import RenderConfig
    from pathtracer.ops import intersect_pallas as ip
    from pathtracer.ops.intersect import intersect_brute, occluded_brute

    cfg = RenderConfig()
    for name, scene in (("hero", hero), ("field", field)):
        acc = scene.accel
        o, d = chip_smoke.test_rays(scene, RAYS, seed=2)
        os_, ds_, _ = acc._sorted_rays("spatial", o, d, cfg)
        sort_fn = jax.jit(lambda o, d: acc._sorted_rays("spatial", o, d, cfg)[:2])
        _, med, mn = timed(sort_fn, o, d)
        emit(phase="kernels", scene=name, variant="spatial sort", median_s=med,
             min_s=mn)

        def kern(r, tb, nw, branch, occluded):
            fn = ip.occluded_clusters if occluded else ip.intersect_clusters
            kw = dict(rays_per_tile=r, tri_block=tb, num_warps=nw)
            if branch:
                args = (acc.tris16, acc.aabb8_child, acc.order)
                kw.update(supers=(acc.aabb8_super, acc.order_super),
                          branch=branch)
            else:
                args = (acc.tris16, acc.aabb8, acc.order)
            return jax.jit(lambda o, d: fn(*args, o, d, **kw))

        for query, variants in KERNEL_VARIANTS.items():
            for r, tb, nw, br in variants:
                try:
                    first, med, mn = timed(
                        kern(r, tb, nw, br, query == "any"), os_, ds_)
                    emit(phase="kernels", scene=name, query=query,
                         variant=f"triton R={r} tb={tb} warps={nw} "
                         f"branch={br}",
                         compile_s=first, median_s=med, min_s=mn)
                except Exception as e:  # noqa: BLE001 — report and go on
                    emit(phase="kernels", scene=name, query=query,
                         variant=f"R={r} tb={tb} warps={nw} branch={br}",
                         error=str(e)[:300])
        if not baselines:
            continue
        xla = jax.jit(lambda o, d: acc._intersect_xla(
            scene.vertices, o, d, cfg.t_min, cfg.t_max, cfg).t)
        brute = jax.jit(lambda o, d: intersect_brute(
            scene.vertices, o, d, cfg.t_min, cfg.t_max).t)
        xla_any = jax.jit(lambda o, d: acc._occluded_xla(
            scene.vertices, o, d, cfg.t_min, cfg.t_max))
        brute_any = jax.jit(lambda o, d: occluded_brute(
            scene.vertices, o, d, cfg.t_min, cfg.t_max))
        for label, fn, q in (("xla cluster scan", xla, "closest"),
                             ("brute", brute, "closest"),
                             ("xla cluster scan", xla_any, "any"),
                             ("brute", brute_any, "any")):
            first, med, mn = timed(fn, os_, ds_, reps=3)
            emit(phase="kernels", scene=name, query=q, variant=label,
                 compile_s=first, median_s=med, min_s=mn)


# Closest-hit packet sizes the e2e phase renders with (0 = the default).
PACKETS = (0,)


def render_cfg(**kw):
    from pathtracer.config import RenderConfig

    base = dict(width=1920, height=1080, samples_per_launch=10, max_depth=8,
                dof=False, env_mode="equirect", intersector="cluster")
    base.update(kw)
    return RenderConfig(**base)


def time_render(label, scene, camera, cfg, launches: int = 3) -> None:
    import jax.numpy as jnp

    from pathtracer.render.integrator import (
        camera_arrays, render_frame, render_frame_stats,
    )

    cam = camera_arrays(camera, cfg)
    t0 = time.perf_counter()
    _, stats = render_frame_stats(scene, cam, cfg, jnp.int32(0))
    segs = int(stats["segments"]) + int(stats["shadow_segments"])
    render_frame(scene, cam, cfg, jnp.int32(1)).block_until_ready()
    first = time.perf_counter() - t0
    ts = []
    for k in range(launches):
        t0 = time.perf_counter()
        render_frame(scene, cam, cfg, jnp.int32(2 + k)).block_until_ready()
        ts.append(time.perf_counter() - t0)
    emit(phase="e2e", variant=label, segments=segs, compile_and_2_launches_s=first,
         s_per_launch=ts, mrays_per_s=segs / float(np.median(ts)) / 1e6)


def phase_e2e(hero, field) -> None:
    hc, fc = chip_smoke.hero_camera(), chip_smoke.field_camera()
    for rpt in PACKETS:
        time_render(f"hero kernel R={rpt}", hero, hc,
                    render_cfg(pallas_rays_per_tile=rpt))
        time_render(f"field kernel two-level R={rpt}", field, fc,
                    render_cfg(pallas_rays_per_tile=rpt))
    time_render("hero kernel unsorted", hero, hc, render_cfg(sort_rays="off"))
    time_render("field kernel flat", field, fc,
                render_cfg(hier_min_clusters=1 << 30))


def phase_e2e_baselines(hero, field) -> None:
    from pathtracer.accel import cluster

    hc, fc = chip_smoke.hero_camera(), chip_smoke.field_camera()
    time_render("hero brute", hero, hc, render_cfg(intersector="brute"))
    time_render("field brute", field, fc, render_cfg(intersector="brute"),
                launches=1)
    orig = cluster.use_kernel
    cluster.use_kernel = lambda: False
    try:
        # pallas_rays_per_tile is unused on the XLA route; a distinct value
        # gives render_frame a new static config, so it retraces.
        time_render("hero xla cluster scan", hero, hc,
                    render_cfg(pallas_rays_per_tile=16), launches=2)
        time_render("field xla cluster scan", field, fc,
                    render_cfg(pallas_rays_per_tile=16), launches=1)
    finally:
        cluster.use_kernel = orig


def phase_ops() -> None:
    import jax
    import jax.numpy as jnp

    def onehot_rows(table, idx):
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, table.shape[0]), 1)
        onehot = (idx[:, None] == iota).astype(table.dtype)
        return jnp.dot(onehot, table, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)

    def take_rows(table, idx):
        return table[idx]

    def tri_cumsum(x):
        xf = x.astype(jnp.float32).reshape(-1, 128)
        tri = jnp.tril(jnp.ones((128, 128), jnp.float32))
        within = jnp.dot(xf, tri.T, precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        row_tot = within[:, -1]
        out = within + (jnp.cumsum(row_tot) - row_tot)[:, None]
        return out.reshape(-1).astype(jnp.int32)

    def looped(fn, make, iters=200):
        @jax.jit
        def run(key):
            def body(i, acc):
                out = fn(*make(jax.random.fold_in(key, i)))
                return acc + out.reshape(-1)[:8].astype(jnp.float32).sum()
            return jax.lax.fori_loop(0, iters, body, jnp.float32(0))
        _, med, _ = timed(run, jax.random.PRNGKey(0), reps=5)
        return med / iters

    rs = np.random.RandomState(0)
    # The one-hot form needs a [lanes, rows] operand: 2306 rows (hero
    # triangle attributes) and 4 (materials); 98k rows would be 51 GB.
    for rows, cols in ((2306, 32), (4, 40)):
        table = jnp.asarray(rs.rand(rows, cols).astype(np.float32))

        def make(k, rows=rows):
            return table, jax.random.randint(k, (RAYS,), 0, rows)

        ref = take_rows(*make(jax.random.PRNGKey(1)))
        got = onehot_rows(*make(jax.random.PRNGKey(1)))
        for label, fn in (("one-hot HIGHEST", onehot_rows), ("take", take_rows)):
            emit(phase="ops", op=f"row lookup [{rows},{cols}] x {RAYS}",
                 variant=label, s_per_call=looped(fn, make),
                 exact=bool(jnp.array_equal(ref, got)))

    def make_mask(k):
        return (jax.random.uniform(k, (RAYS,)) < 0.1,)

    for label, fn in (("triangular matmul HIGHEST", lambda m: tri_cumsum(m)),
                      ("jnp.cumsum", lambda m: jnp.cumsum(m.astype(jnp.int32)))):
        emit(phase="ops", op=f"prefix sum {RAYS}", variant=label,
             s_per_call=looped(fn, make_mask))


def phase_trace(hero, field, out_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from pathtracer.render.integrator import (
        camera_arrays, render_frame, render_frame_stats,
    )

    cfg = render_cfg()
    for name, scene, camera in (("hero", hero, chip_smoke.hero_camera()),
                                ("field", field, chip_smoke.field_camera())):
        cam = camera_arrays(camera, cfg)
        render_frame(scene, cam, cfg, jnp.int32(0)).block_until_ready()
        stats = render_frame_stats(scene, cam, cfg, jnp.int32(1))[1]
        iters = int(stats["iters"])
        tdir = os.path.join(out_dir, f"trace_{name}")
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            render_frame(scene, cam, cfg, jnp.int32(1)).block_until_ready()
        window = time.perf_counter() - t0
        emit(phase="trace", scene=name, iters=iters,
             segments=int(stats["segments"]), window_s=window,
             **trace_summary(tdir, iters))


def trace_summary(tdir: str, iters: int) -> dict:
    """Device busy time, idle share and top ops from an xplane trace."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = ProfileData.from_file(path)
    per_op: dict = {}
    spans = []
    lines = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = [
                len(evs), sum(e.duration_ns for e in evs) / 1e9
            ]
            if not line.name.lower().startswith("stream"):
                continue
            for ev in evs:
                spans.append((ev.start_ns, ev.end_ns))
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
    if not spans:
        return {"error": "no device events in trace", "lines": lines}
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:15]
    traversal = sum(v for k, v in per_op.items() if "kernel" in k and (
        "closest" in k or "occluded" in k))
    return dict(
        device_busy_s=busy / 1e9, device_window_s=window / 1e9,
        idle_share=1.0 - busy / window,
        busy_per_iter_us=busy / 1e3 / iters,
        traversal_per_iter_us=traversal / 1e3 / iters,
        non_traversal_per_iter_us=(sum(per_op.values()) - traversal) / 1e3 / iters,
        top_ops_ms={k[:80]: v / 1e6 for k, v in top},
        lines=lines,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,e2e,ops,trace")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "measure"))
    ap.add_argument("--packets", default="0",
                    help="comma list of closest-hit packet sizes for e2e "
                    "(0 = the default)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    global PACKETS
    PACKETS = tuple(int(x) for x in args.packets.split(","))

    import jax

    from pathtracer.utils.logging import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"measure_gpu: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    emit(card=chip_smoke.card_line(), device_kind=dev.device_kind,
         device_count=len(jax.devices()))
    os.makedirs(args.out, exist_ok=True)
    hero = field = None
    if set(phases) & {"kernels", "baselines", "e2e", "e2e_baselines",
                      "trace"}:
        _, hero, field = chip_smoke.scenes(args.out)
    if "kernels" in phases or "baselines" in phases:
        phase_kernels(hero, field, baselines="baselines" in phases)
    if "ops" in phases:
        phase_ops()
    if "e2e" in phases:
        phase_e2e(hero, field)
    if "e2e_baselines" in phases:
        phase_e2e_baselines(hero, field)
    if "trace" in phases:
        phase_trace(hero, field, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
