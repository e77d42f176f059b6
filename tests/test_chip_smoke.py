"""chip_smoke.py rehearsed on the CPU: every phase at its rehearsal size,
the refusals, and the result line. The GPU run itself happens on the
card (README, "On the GPU")."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SZ = cs.REHEARSE


def _env_cpu():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# phases at rehearsal size
# ---------------------------------------------------------------------------

def test_phase_native(monkeypatch, tmp_path):
    """The rebuild runs make on a copy (other test workers may hold the
    package's library open), then the Morton check runs."""
    from rust_ray_tracer_tpu import native

    src = os.path.dirname(native.__file__)
    for f in ("Makefile", "rrt_native.cpp"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    built = []

    def build(force=False):
        subprocess.run(["make", "-B", "-C", str(tmp_path)], check=True,
                       capture_output=True)
        built.append(force)
        return str(tmp_path / "librrt_native.so")

    monkeypatch.setattr(native, "build", build)
    cs.phase_native(SZ)
    assert built == [True] and (tmp_path / "librrt_native.so").exists()


def test_phase_cli(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    cs.phase_cli(SZ)
    out = capsys.readouterr().out
    for name in ("final_scene", "cornell_triangle"):
        assert (tmp_path / f"{name}.png").exists()
        assert f"[cli] {name} " in out and "finite=True" in out


def test_phase_cli_band_violation_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="band"):
        cs._cli_render(SZ, "cornell_triangle", 16, 1.0, 1, (5.0, 6.0))


def test_phase_train(capsys):
    cs.phase_train(SZ)
    out = capsys.readouterr().out
    assert out.count("grads finite=True") == SZ.train_steps
    assert "memory_analysis" in out


def test_phase_vs_cpu(capsys):
    cs.phase_vs_cpu(SZ)
    out = capsys.readouterr().out
    assert out.count("-> ok") == 2


def test_phase_resume(capsys):
    cs.phase_resume(SZ)
    out = capsys.readouterr().out
    assert out.count("bitwise: True") == 2


def test_phase_kernel(capsys):
    cs.phase_kernel(SZ, rehearse=True)
    out = capsys.readouterr().out
    assert out.count("-> ok") == 5


def test_phase_four(capsys):
    cs.phase_four(SZ)
    out = capsys.readouterr().out
    assert out.count("4 vs 2 devices bitwise True") == 2
    assert "train step" in out and "-> ok" in out


# ---------------------------------------------------------------------------
# refusals and the result line
# ---------------------------------------------------------------------------

def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env_cpu(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _env_cpu()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse-cpu"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _stub_phases(monkeypatch, fail=()):
    ran = []

    def make(name):
        def phase(*a, **k):
            ran.append(name)
            if name in fail:
                raise RuntimeError(f"{name} broke")
        return phase

    for name in ("native", "cli", "train", "vs_cpu", "resume", "kernel",
                 "four"):
        monkeypatch.setattr(cs, f"phase_{name}", make(name))
    monkeypatch.setattr(cs.runtime, "enable_compile_cache", lambda: "x")
    return ran


def test_last_line_is_the_result_object(monkeypatch, capsys):
    ran = _stub_phases(monkeypatch)
    assert cs.main(["--rehearse-cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    obj = json.loads(last)
    assert obj == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
    assert ran == ["native", "cli", "train", "vs_cpu", "resume", "kernel"]


def test_failed_phase_exits_nonzero_without_result(monkeypatch, capsys):
    ran = _stub_phases(monkeypatch, fail=("train",))
    assert cs.main(["--rehearse-cpu"]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    # later phases still run and report
    assert ran[-1] == "kernel"


def test_four_runs_only_the_sharded_phase(monkeypatch, capsys):
    ran = _stub_phases(monkeypatch)
    assert cs.main(["--rehearse-cpu", "--four"]) == 0
    assert ran == ["four"]


def test_phase_device_rehearsal_reports_cpu(capsys):
    rec = cs.phase_device(rehearse=True)
    assert rec["platform"] == "cpu"
    assert "nvidia-smi not queried" in capsys.readouterr().out


def test_phase_device_requires_a_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device(rehearse=False)


# ---------------------------------------------------------------------------
# helpers and the pinned shapes
# ---------------------------------------------------------------------------

def test_compare_images():
    a = np.ones((4, 5, 3), np.float32)
    assert cs.compare_images(a, a) == (0.0, 0.0)
    b = a.copy()
    b[0, 0] += 0.01
    rel, flips = cs.compare_images(b, a)
    assert flips == pytest.approx(1 / 20)
    assert rel == pytest.approx(0.03 / 60, rel=1e-3)  # 3 channels


def test_agreement_counts_ties_and_misses():
    inf = np.inf
    t = np.array([1.0, 2.0, inf, 3.0])
    i = np.array([4, 5, 0, 6])
    assert cs.agreement(t, i, t, i) == (1.0, 0.0)
    t2, i2 = t.copy(), i.copy()
    i2[1] = 9                   # a tie: other index, same t
    t2[2], i2[2] = inf, 7       # both miss: same, whatever the index
    same, gap = cs.agreement(t, i, t2, i2)
    assert same == 0.75 and gap == 0.0
    t2[1] = 2.5
    assert cs.agreement(t, i, t2, i2)[1] == pytest.approx(0.25)


def test_xla_search_context_restores():
    from rust_ray_tracer_tpu.ops import intersect
    before = intersect._tri_candidates
    with cs.xla_triangle_search():
        assert intersect._tri_candidates is not before
    assert intersect._tri_candidates is before


def test_gpu_sizes_are_the_specified_workloads():
    g = cs.GPU
    assert int(g.final_h * g.final_aspect) == 1920 and g.final_h == 1080
    assert (g.final_spp, g.depth, g.cornell_h) == (16, 4, 512)
    assert (g.train_wh, g.train_spp, g.train_chunk, g.train_steps) == \
        ((512, 288), 4, 9216, 5)
    assert (g.cmp_wh, g.cmp_spp) == ((128, 72), 4)
    assert g.final_band[0] > 0 and g.cornell_band[0] > 0
    assert cs.SCENE_BUDGET["final_scene"] == (2e-2, 0.01)
    assert cs.DEFAULT_BUDGET == (1e-3, 0.02)


def test_kernel_rays_mix_primary_incoherent_and_dead():
    sd = cs._scene("flagship", 16 / 9)
    o, d, t_min, t_max = cs._kernel_rays(sd, (32, 18), 64,
                                         jax.random.PRNGKey(0))
    assert o.shape == d.shape == (128, 3)
    assert int(jnp.sum(t_max < 0)) == len(range(0, 128, 5))
    assert np.isfinite(np.asarray(o)).all()
