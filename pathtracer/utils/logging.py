"""Structured logging with the reference's level-tag format.

Replaces `context_log_cb` (reference optixSphere.cpp:135-138), which prints
`[level][tag]: message` to stderr at verbosity 4, and the ad-hoc progress
couts during scene load (cpp:361-362, 594, 648, 750)."""

from __future__ import annotations

import sys
import time
from typing import Optional

_LEVELS = {"fatal": 1, "error": 2, "warn": 3, "info": 4, "debug": 5}
_verbosity = 4
_start = time.time()


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def log(level: str, tag: str, message: str, stream=None) -> None:
    lv = _LEVELS.get(level, 4)
    if lv > _verbosity:
        return
    stream = stream or sys.stderr
    t = time.time() - _start
    stream.write(f"[{lv:2d}][{tag:>12s}][{t:8.2f}s]: {message}\n")
    stream.flush()


def info(tag: str, message: str) -> None:
    log("info", tag, message)


def warn(tag: str, message: str) -> None:
    log("warn", tag, message)


_warned: set = set()


def warn_once(tag: str, message: str) -> None:
    """warn(), deduplicated by (tag, message) for the process lifetime —
    for per-call-site notices inside jit-traced builders (traced multiple
    times per config)."""
    key = (tag, message)
    if key in _warned:
        return
    _warned.add(key)
    warn(tag, message)


def error(tag: str, message: str) -> None:
    log("error", tag, message)


def debug(tag: str, message: str) -> None:
    log("debug", tag, message)


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`.

    A fixed path: the cache key includes it, so a moving directory would
    never hit."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(checkout, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    so later processes (CLI, bench, chip_smoke) skip recompiles; returns
    the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
