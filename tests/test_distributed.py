"""2-process jax.distributed smoke test.

`parallel.shard.initialize_distributed` is the one path a real multi-host
pod needs that the single-process virtual-device mesh tests never touch.
Spawn two real OS processes, wire them into a jax.distributed cluster
over a localhost coordinator, and have each render + verify a shard of a
pixel-sharded frame (tests/_dist_worker.py).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_render():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p
    )
    # The workers force the CPU backend themselves (jax.config.update
    # before backend init); drop any virtual-device flag the test session
    # set so each worker owns exactly one device.
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_dist_worker.py"),
             str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"DIST_OK p{pid}" in out, f"worker {pid} output:\n{out}"
