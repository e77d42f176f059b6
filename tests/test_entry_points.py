"""Entry points outside the package: __graft_entry__, bench.py, the
multi-host join and the native build."""

import os
import subprocess

import jax
import numpy as np
import pytest

import __graft_entry__ as ge


def test_entry_forward_step():
    fn, args = ge.entry()
    img = jax.jit(fn)(*args)
    assert img.shape == (72, 128, 3)
    assert np.isfinite(np.asarray(img)).all() and float(img.mean()) > 0


def test_dryrun_multichip_on_virtual_devices(capsys):
    loss, grads = ge.dryrun_multichip(4, virtual_cpu=True)
    assert np.isfinite(float(loss))
    assert float(np.abs(np.asarray(grads.tex_color)).max()) > 0
    assert "dryrun_multichip(4) on cpu: ok" in capsys.readouterr().out


def test_dryrun_refuses_missing_devices():
    with pytest.raises(RuntimeError, match="device"):
        ge.dryrun_multichip(64)


def test_flagship_scene_scales_with_n_tris():
    assert ge._flagship_scene().n_tris == 1024         # 968 padded
    sd = ge._flagship_scene(3000)
    assert sd.n_tris == 3072 and sd.tri_cluster_min.shape == (24, 3)


def test_bench_refuses_without_gpu(capsys):
    import bench
    assert bench.main() == 1
    assert "no GPU" in capsys.readouterr().err


def test_multihost_init_noop_when_joined(monkeypatch):
    from rust_ray_tracer_tpu.parallel import mesh
    calls = []
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    mesh.multihost_init("localhost:1", 2, 0)
    assert calls == []


def test_multihost_init_propagates_failures(monkeypatch):
    from rust_ray_tracer_tpu.parallel import mesh

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        mesh.multihost_init("localhost:1", 2, 0)


def test_native_build_is_portable_and_forced(monkeypatch):
    from rust_ray_tracer_tpu import native
    here = os.path.dirname(native.__file__)
    with open(os.path.join(here, "Makefile")) as f:
        assert "-march=native" not in f.read()
    runs = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: runs.append(cmd))
    native.build(force=True)
    assert runs == [["make", "-B", "-C", here]]
