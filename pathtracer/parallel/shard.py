"""Multi-chip rendering: shard_map over a device mesh with XLA collectives.

The reference is strictly single-GPU (one `optixLaunch` per frame, one CUDA
stream — reference optixSphere.cpp:1288-1289, 1409-1418); its SURVEY.md §2
parallelism table is all "absent".  This module supplies the multi-device
scale-out (XLA hands the collectives to NCCL on GPUs):

* **pixel sharding** (`mode="pixels"`): the flat pixel array splits across
  the `dp` mesh axis; every chip renders its slice against the replicated
  scene.  No collective needed (all_gather happens implicitly at the
  output sharding boundary).  Bitwise-identical to a single-chip render
  because seeds are keyed by *global* pixel/sample ids.
* **sample sharding** (`mode="samples"`): every chip renders the full
  pixel grid with a disjoint slice of the global sample ids and the frame
  is averaged with `pmean` — the "long-context analog" from
  SURVEY.md §5 (spp is the scaling dimension; radiance tree-reduces).

Scene data (triangles + BVH + textures + env) is replicated: even the
largest reference scene is ~50 MB, far below HBM (SURVEY.md §5).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pathtracer.config import RenderConfig
from pathtracer.render.integrator import render_pixels

def shard_map(*args, **kw):
    """jax.shard_map with varying-manual-axes checking off.

    The render worker calls pallas_call, whose out_shape avals carry no
    `vma` annotation — under check_vma=True (the default) that is a hard
    error inside shard_map.  The sharding here is embarrassingly parallel
    (per-pixel / per-sample partitions, one pmean), so the check buys
    nothing.

    NOTE for new shard_map users in this package: every sharded path
    routed through this wrapper inherits the disabled check — a wrong
    out_spec/replication claim will NOT error here; cover new paths with
    a bitwise sharded-vs-single test (tests/test_parallel.py pattern)."""
    return jax.shard_map(*args, check_vma=False, **kw)


def initialize_distributed(**kw) -> None:
    """Multi-host init: wire this process into a jax.distributed cluster.
    Pass coordinator_address (e.g. "localhost:<port>"), num_processes and
    process_id.  After this, `make_mesh()` sees every device of the
    cluster and pixel/sample sharding scales across hosts unchanged —
    the SURVEY §5 "across hosts via standard jax.distributed" recipe.
    """
    jax.distributed.initialize(**kw)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1-D device mesh over the first n (default: all) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh", "mode", "axis")
)
def render_frame_sharded(
    scene,
    cam: dict,
    cfg: RenderConfig,
    subframe: jnp.ndarray,
    mesh: Mesh,
    mode: str = "pixels",
    axis: str = "dp",
) -> jnp.ndarray:
    """Render one launch across the mesh; returns [H,W,3] radiance."""
    ndev = mesh.shape[axis]
    n_pix = cfg.width * cfg.height

    if mode == "pixels":
        if n_pix % ndev != 0:
            raise ValueError(
                f"width*height ({n_pix}) must divide across {ndev} devices"
            )
        chunk = n_pix // ndev

        def worker(scene, cam, subframe):
            # Affine id range (base, count) instead of a materialized id
            # array: the streaming schedule's slot->pixel map then stays
            # arithmetic — the per-iteration gather from the sharded id
            # table is the cost this avoids.  Seeds key off
            # the same global pixel ids, so output stays bitwise-identical.
            base = jax.lax.axis_index(axis).astype(jnp.int32) * chunk
            return render_pixels(scene, cam, cfg, (base, chunk), subframe)

        img = shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(axis),
        )(scene, cam, subframe)
        return img.reshape(cfg.height, cfg.width, 3)

    if mode == "samples":
        spp = cfg.samples_per_launch
        if spp % ndev != 0:
            raise ValueError(
                f"samples_per_launch ({spp}) must divide across {ndev} devices"
            )
        spp_local = spp // ndev

        def worker(scene, cam, subframe):
            dev = jax.lax.axis_index(axis)
            ids = jnp.arange(n_pix, dtype=jnp.int32)
            img = render_pixels(
                scene, cam, cfg, ids, subframe,
                sample_offset=dev * spp_local, spp=spp_local,
            )
            # Average the partial frames across devices.
            return jax.lax.pmean(img, axis)

        img = shard_map(
            worker,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(),
        )(scene, cam, subframe)
        return img.reshape(cfg.height, cfg.width, 3)

    raise ValueError(f"unknown sharding mode: {mode!r}")
