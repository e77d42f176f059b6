"""The eight procedural scenes compile and render finite images."""

import numpy as np
import jax
import pytest

from rust_ray_tracer_tpu.models import builders
from rust_ray_tracer_tpu.models.scene import compile_scene
from rust_ray_tracer_tpu.ops.integrator import render_image

# keep CI fast: tiny renders; heavy scenes get even smaller
_SIZES = {"random": (12, 8), "final_scene": (12, 8)}


@pytest.mark.parametrize("name", builders.SCENE_TYPES)
def test_scene_builds_and_renders(name):
    scene = builders.get_scene(name, aspect=1.5, seed=0)
    sd = compile_scene(scene)
    w, h = _SIZES.get(name, (16, 12))
    img = np.asarray(render_image(sd, w, h, 1, jax.random.PRNGKey(0),
                                  depth=2, chunk_size=256))
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all(), f"{name}: non-finite radiance"


def test_scene_counts_cornell():
    sd = compile_scene(builders.get_scene("cornell_box", 1.0))
    # 6 walls + 2 cuboids (12 quads) = 18 quads, 1 light
    assert sd.n_quads >= 18
    assert sd.n_lights == 1
    assert sd.n_tris == 0 or sd.tri_v0.shape[0] % 64 == 0


def test_scene_counts_final():
    sd = compile_scene(builders.get_scene("final_scene", 1.0))
    assert sd.n_quads >= 15 * 15 * 6        # ground boxes
    assert sd.n_spheres >= 15               # various + cluster of 10
    assert sd.n_media == 2
    assert sd.n_lights == 1                 # FlipFace -> LIGHT_NULL
    from rust_ray_tracer_tpu.models.scene import LIGHT_NULL
    assert int(sd.light_kind[0]) == LIGHT_NULL


def test_unknown_scene_raises():
    with pytest.raises(ValueError):
        builders.get_scene("nope", 1.0)


def test_cornell_brightness_sanity():
    """The lamp region must be the brightest part of the render."""
    sd = compile_scene(builders.get_scene("cornell_box", 1.0))
    img = np.asarray(render_image(sd, 24, 24, 2, jax.random.PRNGKey(1),
                                  depth=4, chunk_size=576))
    assert np.isfinite(img).all()
    assert img.max() > 1.0      # emissive seen directly (15,15,15)
    assert img.mean() > 1e-3    # walls lit


@pytest.mark.parametrize("n_tris", [968, 200])
def test_flagship_builder(n_tris):
    """The procedural flagship mesh: seeded (same scene twice), sized by
    n_tris, double-sided triangles plus one sphere lamp in the light list."""
    a = compile_scene(builders.flagship(16 / 9, 0, n_tris))
    b = compile_scene(builders.get_scene("flagship", 16 / 9))
    real = int((np.abs(np.asarray(a.tri_e1)).sum(1) > 0).sum())
    assert real == n_tris
    assert a.n_spheres >= 1 and a.n_lights == 1
    assert bool(np.asarray(a.tri_double)[:n_tris].all())
    if n_tris == 968:
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
