"""Process set-up shared by the entry points (CLI, bench, chip smoke,
``__graft_entry__``): the compile-cache rule and what a run reports about
the device it ran on."""

from __future__ import annotations

import os
import subprocess

# the repository checkout that holds this package
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache`` (listed in ``.gitignore``): the directory is
    part of the cache key, so a temporary or per-process path would
    never hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``device_record()``, or RuntimeError when JAX found no GPU. A
    measurement never falls back to the CPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {rec['platform']!r} "
            f"({rec['kind']})")
    return rec


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` CSV lines -> [(name, power_limit)]."""
    out = []
    for line in text.splitlines():
        if line.strip():
            name, _, limit = line.rpartition(",")
            out.append((name.strip(), limit.strip()))
    return out


def nvidia_smi() -> str:
    """Card names and power limits, read by a child process that does not
    import JAX (``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``)."""
    return subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
