"""utils/runtime: the compile-cache rule and the device report."""

import os

import jax
import pytest

from rust_ray_tracer_tpu.utils import runtime


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after a test changes it."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_env_set_is_used_and_nothing_is_set(monkeypatch, tmp_path,
                                                  cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_env_unset_falls_back_to_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    assert got == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isfile(os.path.join(runtime.REPO_ROOT, "chip_smoke.py"))


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(runtime.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_has_no_cache_dir_option():
    from rust_ray_tracer_tpu.utils.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["16", "1", "--cache-dir", "x"])


def test_cli_applies_the_cache_rule(monkeypatch, tmp_path):
    from rust_ray_tracer_tpu.utils import cli
    calls = []
    monkeypatch.setattr(runtime, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    rc = cli.main(["8", "1", "--scene", "cornell_box", "-a", "1.0",
                   "-o", str(tmp_path / "c.png"), "--chunk-size", "64",
                   "--devices", "1", "--checkpoint", str(tmp_path / "c.k")])
    assert rc == 0 and calls == [1]


@pytest.mark.parametrize("text,expect", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "400.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("\n  NVIDIA H100 PCIe , 350.00 W  \n\n",
     [("NVIDIA H100 PCIe", "350.00 W")]),
])
def test_parse_nvidia_smi(text, expect):
    assert runtime.parse_nvidia_smi(text) == expect


def test_nvidia_smi_missing_raises(monkeypatch):
    monkeypatch.setattr(runtime, "NVIDIA_SMI_QUERY",
                        ["nvidia-smi-not-installed-here"])
    with pytest.raises(OSError):
        runtime.nvidia_smi()


def test_device_record_reports_jax_devices():
    rec = runtime.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": 8}


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
