"""Scene families through the XLA wavefront path.

One small scene per family the renderer supports — solid-colour
triangles, checker texture, quads with an area light, marble noise, a
constant medium, and a triangle mesh — checked three ways:

* forward: the wavefront render against the independent recursive NumPy
  oracle (``tests/oracle.py``), 4x4-block means and the whole-image mean;
* gradients: autodiff of the mean radiance against central finite
  differences of one smooth parameter (common random numbers);
* sharding: 4 virtual devices against 2, bitwise (the D >= 2 invariant of
  ``parallel/render.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import builders
from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import compile_scene
from rust_ray_tracer_tpu.ops.camera import make_camera
from rust_ray_tracer_tpu.ops.integrator import render_image
from rust_ray_tracer_tpu.parallel.mesh import make_mesh
from rust_ray_tracer_tpu.parallel.render import (render_waves_sharded,
                                                 replicate_scene)

from tests.oracle import render_oracle

W, H = 16, 12
SKY = (0.7, 0.8, 1.0)


def _cam():
    return make_camera(np.eye(3, 4, dtype=np.float32), 50.0, W / H)


def solid():
    grey = S.Lambertian.from_rgb(0.6, 0.5, 0.4)
    return compile_scene(S.Scene(_cam(), [
        S.Triangle((-3, -1.5, -6), (3, -1.5, -6), (3, 2.5, -7), grey),
        S.Triangle((-3, -1.5, -6), (3, 2.5, -7), (-3, 2.5, -7), grey),
        S.Sphere((0.8, -0.5, -4), 0.7, S.Metal((0.9, 0.8, 0.7), 0.2)),
    ], [], SKY))


def checker():
    return compile_scene(S.Scene(_cam(), [
        S.Sphere((0, -101, -4), 100.0, S.Lambertian(
            S.Checker.from_colors((0.9, 0.2, 0.1), (0.1, 0.8, 0.2)))),
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.5, 0.6)),
    ], [], SKY))


def quad():
    lamp = S.XZRect(-0.6, 0.6, -4.6, -3.4, 1.95,
                    S.DiffuseLight.from_color((6, 6, 6)))
    white = S.Lambertian.from_rgb(0.7, 0.7, 0.7)
    return compile_scene(S.Scene(_cam(), [
        S.XZRect(-2.0, 2.0, -6.0, -2.0, -2.0, white),
        S.XZRect(-2.0, 2.0, -6.0, -2.0, 2.0, white),
        S.YZRect(-2.0, 2.0, -6.0, -2.0, -2.0,
                 S.Lambertian.from_rgb(0.6, 0.2, 0.2)),
        S.YZRect(-2.0, 2.0, -6.0, -2.0, 2.0,
                 S.Lambertian.from_rgb(0.2, 0.6, 0.2)),
        S.XYRect(-2.0, 2.0, -2.0, 2.0, -6.0, white),
        S.Sphere((0.5, -1.2, -4.5), 0.7, S.Dielectric(1.5)),
        lamp,
    ], [lamp], (0, 0, 0)))


def noise():
    return compile_scene(S.Scene(_cam(), [
        S.Sphere((0, 0, -4), 1.6, S.Lambertian(S.Noise(4.0))),
    ], [], SKY))


def medium():
    return compile_scene(S.Scene(_cam(), [
        S.XYRect(-4, 4, -3, 3, -7, S.Lambertian.from_rgb(0.8, 0.3, 0.3)),
        S.ConstantMedium.from_color(
            S.Sphere((0, 0, -4), 1.5, S.Dielectric(1.5)), 0.8,
            (0.3, 0.5, 0.9)),
    ], [], SKY))


def triangle_mesh():
    return compile_scene(builders.flagship(W / H, 0, 300))


FAMILIES = {"solid": solid, "checker": checker, "quad": quad,
            "noise": noise, "medium": medium}


# ---------------------------------------------------------------------------
# forward vs the recursive oracle
# ---------------------------------------------------------------------------

# (spp, 4x4-block atol, whole-image rtol); loose where a bright source or
# glass caustic makes single samples swing
FWD = {"solid": (32, 0.05, 0.05), "checker": (32, 0.06, 0.05),
       "quad": (48, 0.2, 0.1), "noise": (32, 0.05, 0.05),
       "medium": (48, 0.08, 0.08)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_oracle(family):
    sd = FAMILIES[family]()
    spp, atol, rtol = FWD[family]
    ours = np.asarray(render_image(sd, W, H, spp, jax.random.PRNGKey(0),
                                   depth=4, chunk_size=192))
    orc = render_oracle(sd, float(sd.camera.scale), float(sd.camera.aspect),
                        np.asarray(sd.camera.c2w), W, H, spp, 4, seed=1)
    assert np.isfinite(ours).all()
    ob = np.minimum(ours, 2.0).reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    rb = np.minimum(orc, 2.0).reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    np.testing.assert_allclose(ob, rb, atol=atol)
    np.testing.assert_allclose(np.minimum(ours, 2.0).mean(),
                               np.minimum(orc, 2.0).mean(), rtol=rtol)


# ---------------------------------------------------------------------------
# gradients vs central finite differences
# ---------------------------------------------------------------------------

def _tex_of(sd, mat_id):
    return int(np.asarray(sd.mat_tex)[mat_id])


def _param(family, sd):
    """(theta0, eps, scene_of_theta) for one smooth parameter."""
    if family == "solid":           # triangle albedo
        tid = _tex_of(sd, int(np.asarray(sd.tri_mat)[0]))
        return 0.5, 1e-2, lambda a: sd._replace(
            tex_color=sd.tex_color.at[tid].set(jnp.full(3, a)))
    if family == "checker":         # the checker's even leaf colour
        tid = int(np.asarray(sd.tex_even)[
            _tex_of(sd, int(np.asarray(sd.sph_mat)[0]))])
        if int(np.asarray(sd.tex_kind)[_tex_of(
                sd, int(np.asarray(sd.sph_mat)[0]))]) != 1:
            tid = int(np.asarray(sd.tex_even)[_tex_of(
                sd, int(np.asarray(sd.sph_mat)[1]))])
        return 0.5, 1e-2, lambda a: sd._replace(
            tex_color=sd.tex_color.at[tid].set(jnp.full(3, a)))
    if family == "quad":            # lamp emission
        lamp = int(np.asarray(sd.quad_mat)[np.argmax(
            np.asarray(sd.tex_color)[np.asarray(sd.mat_tex)[
                np.asarray(sd.quad_mat)]].sum(1))])
        tid = _tex_of(sd, lamp)
        return 6.0, 5e-2, lambda e: sd._replace(
            tex_color=sd.tex_color.at[tid].set(jnp.full(3, e)))
    if family == "noise":           # marble frequency
        tid = _tex_of(sd, int(np.asarray(sd.sph_mat)[0]))
        return 4.0, 1e-2, lambda s: sd._replace(
            tex_scale=sd.tex_scale.at[tid].set(s))
    if family == "medium":          # isotropic phase albedo
        tid = _tex_of(sd, int(np.asarray(sd.med_mat)[0]))
        return 0.5, 1e-2, lambda a: sd._replace(
            tex_color=sd.tex_color.at[tid].set(jnp.full(3, a)))
    raise KeyError(family)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grad_matches_finite_difference(family):
    sd = FAMILIES[family]()
    theta0, eps, scene_of = _param(family, sd)
    key = jax.random.PRNGKey(3)

    def loss(theta):
        img = render_image(scene_of(theta), 8, 6, 2, key, depth=3,
                           chunk_size=48)
        return jnp.mean(img)

    g = float(jax.grad(loss)(jnp.float32(theta0)))
    fd = (float(loss(jnp.float32(theta0 + eps)))
          - float(loss(jnp.float32(theta0 - eps)))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g) > 1e-6, "parameter must matter"
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# 4 virtual devices vs 2: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family",
                         sorted(FAMILIES) + ["triangle_mesh"])
def test_four_vs_two_devices_bitwise(family):
    sd = (FAMILIES.get(family) or triangle_mesh)()
    key = jax.random.PRNGKey(5)
    imgs = []
    for n in (4, 2):
        mesh = make_mesh(n_devices=n)
        imgs.append(np.asarray(render_waves_sharded(
            replicate_scene(sd, mesh), W, H, key, 0, 2, mesh,
            chunk_size=32)))
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])
