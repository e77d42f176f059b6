"""Cross-chunk alive compaction (integrator.trace_wave_compact).

The compacting wavefront follows IDENTICAL sampled trajectories to the
per-chunk path (per-ray randomness is gathered from the ray's original
(chunk, lane) coordinate), so renders compare directly — only
fp-reassociation drift (XLA fuses the permuted graph differently) is
allowed. Reference behavior matched: the CPU recursion pays only for
live paths (ray.rs:85-126).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import compile_scene, partition, combine
from rust_ray_tracer_tpu.ops.camera import make_camera
from rust_ray_tracer_tpu.ops.integrator import render_waves


def occupancy_scene(with_medium=False):
    """random-scene shape: bright sky + full-frame ground keeps roughly
    half the lanes alive at every bounce, spread across all chunks —
    the workload compaction exists for."""
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    world = [
        S.Sphere((0, -101, -4), 100.0,
                 S.Lambertian(S.Checker.from_colors((0.9, 0.1, 0.1),
                                                    (0.1, 0.9, 0.1)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.4, 0.3)),
        S.Sphere((-2.2, 0, -4), 1.0, S.Metal((0.8, 0.8, 0.9), 0.1)),
        S.MovingSphere((2.2, 0, -4), (2.4, 0.2, -4), 0.0, 1.0, 1.0,
                       S.Dielectric(1.5)),
        S.Triangle((-3, 0.5, -6), (3, 0.5, -6), (0, 3.5, -7),
                   S.Lambertian.from_rgb(0.7, 0.6, 0.5),
                   double_sided=True),
        S.XZRect(-1.0, 1.0, -5.0, -3.0, 3.0,
                 S.DiffuseLight.from_color((5, 5, 5))),
    ]
    lights = [world[-1]]
    if with_medium:
        world.append(S.ConstantMedium.from_color(
            S.Sphere((0.5, 0.8, -2.5), 0.6, S.Dielectric(1.5)),
            0.7, (0.9, 0.9, 0.9)))
    return compile_scene(S.Scene(cam, world, lights, (0.7, 0.8, 1.0)))


@pytest.mark.parametrize("with_medium", [False, True])
def test_compact_matches_per_chunk(with_medium):
    sd = occupancy_scene(with_medium)
    key = jax.random.PRNGKey(9)
    a = np.asarray(render_waves(sd, 64, 48, key, 0, 2, chunk_size=256))
    b = np.asarray(render_waves(sd, 64, 48, key, 0, 2, chunk_size=256,
                                compact=True))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=5e-6, rtol=1e-4)


def test_compact_deterministic_and_chunk_shape_independent_of_pad():
    """Same (seed, chunk_size) -> bitwise same image; ragged final chunk
    (n % chunk_size != 0) handled."""
    sd = occupancy_scene()
    key = jax.random.PRNGKey(4)
    r = lambda: np.asarray(render_waves(sd, 50, 30, key, 0, 1,  # noqa: E731
                                        chunk_size=256, compact=True))
    a, b = r(), r()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()


def test_compact_grads_match():
    sd = occupancy_scene()
    key = jax.random.PRNGKey(11)
    diff, static = partition(sd)

    def loss(diff, compact):
        img = render_waves(combine(diff, static), 32, 24, key, 0, 1,
                           chunk_size=192, compact=compact)
        return jnp.mean(img)

    g_ref = jax.grad(lambda d: loss(d, False))(diff)
    g_got = jax.grad(lambda d: loss(d, True))(diff)
    nonzero = 0
    for name in ("tex_color", "sph_c0", "sph_r", "mat_fuzz",
                 "background", "light_q"):
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_got, name))
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=1e-6,
                                   err_msg=name)
        nonzero += bool((a != 0).any())
    assert nonzero >= 4


def test_compact_sharded_matches_sequential():
    """Shard-local compaction over an 8-device CPU mesh reproduces the
    sequential compact render (per-ray randomness keyed by global chunk
    id; compaction never crosses shards)."""
    from rust_ray_tracer_tpu.parallel.mesh import make_mesh
    from rust_ray_tracer_tpu.parallel.render import (render_waves_sharded,
                                                     replicate_scene)

    sd = occupancy_scene()
    key = jax.random.PRNGKey(2)
    seq = np.asarray(render_waves(sd, 64, 48, key, 0, 1, chunk_size=256,
                                  compact=True))
    mesh = make_mesh(n_devices=8)
    shd = np.asarray(render_waves_sharded(
        replicate_scene(sd, mesh), 64, 48, key, 0, 1, mesh,
        chunk_size=256, compact=True))
    assert np.isfinite(shd).all()
    np.testing.assert_allclose(shd, seq, atol=5e-6, rtol=1e-4)


def test_compact_proc_chunk_invariance():
    """The processing-chunk size is a pure scheduling knob: randomness
    and primaries stay keyed by the original RNG chunk, so the image is
    invariant to proc_chunk (fp-reassociation tolerance)."""
    sd = occupancy_scene()
    key = jax.random.PRNGKey(6)
    a = np.asarray(render_waves(sd, 64, 48, key, 0, 1, chunk_size=256,
                                compact=True))
    b = np.asarray(render_waves(sd, 64, 48, key, 0, 1, chunk_size=256,
                                compact=True, proc_chunk=128))
    c = np.asarray(render_waves(sd, 64, 48, key, 0, 1, chunk_size=256,
                                compact=True, proc_chunk=768))
    np.testing.assert_allclose(b, a, atol=5e-6, rtol=1e-4)
    np.testing.assert_allclose(c, a, atol=5e-6, rtol=1e-4)


class TestAutoCompact:
    """integrator.auto_compact turns compaction on for frame-filling,
    occupancy-bound scenes (most primaries hit and keep scattering) and
    off for small objects in a void (most primaries miss and die at
    bounce 0, so the permutation gathers buy nothing)."""

    def test_frame_filling_scene_on(self):
        from rust_ray_tracer_tpu.ops.integrator import auto_compact
        assert auto_compact(occupancy_scene()) is True

    def test_builders_match_measured_winners(self):
        from rust_ray_tracer_tpu.models import builders
        from rust_ray_tracer_tpu.ops.integrator import auto_compact
        for name in ("random", "cornell_box", "final_scene"):
            sd = compile_scene(builders.get_scene(name, 16 / 9))
            assert auto_compact(sd) is True, name

    def test_small_mesh_in_void_off(self):
        """The flagship mesh: 968 small triangles in front of a dark
        background — most primaries miss."""
        from rust_ray_tracer_tpu.models import builders
        from rust_ray_tracer_tpu.ops.integrator import auto_compact
        sd = compile_scene(builders.flagship(16 / 9))
        assert auto_compact(sd) is False

    def test_empty_scene_off(self):
        from rust_ray_tracer_tpu.ops.integrator import auto_compact
        cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
        sd = compile_scene(S.Scene(cam, [], [], (0, 0, 0)))
        assert auto_compact(sd) is False
