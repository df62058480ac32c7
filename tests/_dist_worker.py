"""Worker for the 2-process jax.distributed smoke test.

Run as:  python tests/_dist_worker.py <coordinator_port> <process_id>

Each of the two processes owns ONE CPU device; together they form the
2-device global mesh.  The worker renders a tiny pixel-sharded frame and
checks its OWN addressable shard bitwise against a locally-computed
single-device render of the same frame, then prints DIST_OK.  This
executes the real `jax.distributed.initialize` path (DCN coordinator,
cross-process device discovery) that single-process mesh tests cannot.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")  # before anything touches a backend

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    port, pid = sys.argv[1], int(sys.argv[2])

    from pathtracer.parallel.shard import (
        initialize_distributed,
        make_mesh,
        render_frame_sharded,
    )

    initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 2, jax.devices()
    assert len(jax.local_devices()) == 1

    from pathtracer.config import RenderConfig
    from pathtracer.render.camera import Camera
    from pathtracer.render.integrator import camera_arrays, render_frame
    from pathtracer.scene.procedural import single_sphere_scene

    cfg = RenderConfig(
        width=32, height=16, samples_per_launch=4, max_depth=3,
        dof=False, env_mode="constant", intersector="brute",
    )
    scene = single_sphere_scene(stacks=6, slices=12)
    cam = camera_arrays(Camera(), cfg)

    mesh = make_mesh()  # global 2-device mesh
    out = render_frame_sharded(scene, cam, cfg, jnp.int32(0), mesh, mode="pixels")

    # Reference: plain single-device render computed independently in
    # THIS process (seeds key off global pixel ids, so the sharded image
    # must match bitwise).
    single = np.asarray(render_frame(scene, cam, cfg, jnp.int32(0)))

    shards = out.addressable_shards
    assert shards, "process owns no shard of the output"
    for s in shards:
        np.testing.assert_array_equal(np.asarray(s.data), single[s.index])

    print(f"DIST_OK p{pid} shards={len(shards)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
