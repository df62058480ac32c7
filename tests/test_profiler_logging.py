"""Observability subsystems (SURVEY.md §5: tracing/profiling + logging):
FrameStats wall-clock buckets, XLA trace capture, and the level-tag
logger that mirrors the reference's context_log_cb format
(reference optixSphere.cpp:135-138, 1386-1431)."""

import io
import os
import time

import jax.numpy as jnp

from pathtracer.runtime.profiler import FrameStats, xla_trace
from pathtracer.utils import logging as plog
import pytest


def test_frame_stats_buckets():
    st = FrameStats()
    with st.bucket("render"):
        time.sleep(0.01)
    with st.bucket("render"):
        pass
    with st.bucket("display"):
        pass
    assert st.counts["render"] == 2 and st.counts["display"] == 1
    assert st.totals["render"] >= 0.01
    s = st.summary()
    assert "render" in s and "display" in s and "x2" in s
    st.reset()
    assert not st.totals and not st.counts


@pytest.mark.slow
def test_xla_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with xla_trace(logdir):
        jnp.arange(128.0).sum().block_until_ready()
    files = [
        os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs
    ]
    assert files, "trace capture produced no files"


def test_log_level_format_and_filtering():
    buf = io.StringIO()
    plog.set_verbosity(4)
    try:
        plog.log("info", "scene", "hello", stream=buf)
        plog.log("debug", "scene", "hidden at verbosity 4", stream=buf)
        out = buf.getvalue()
        # Reference format: [level][tag][time]: message (cpp:135-138).
        assert "[ 4][" in out and "scene" in out and "hello" in out
        assert "hidden" not in out
        plog.set_verbosity(5)
        plog.log("debug", "scene", "now visible", stream=buf)
        assert "now visible" in buf.getvalue()
    finally:
        plog.set_verbosity(4)


def test_warn_once_deduplicates(capsys):
    plog.warn_once("testtag", "dedup me")
    plog.warn_once("testtag", "dedup me")
    err = capsys.readouterr().err
    assert err.count("dedup me") == 1
