"""Differentiability: autodiff pixel gradients vs finite differences.

The reference has no gradients at all; BASELINE.json demands material /
camera / vertex grads via detached sampling ("pixel-grad allclose").
Finite differences use a FIXED rng key so the sampled paths are common
random numbers — the detached-sampling estimator is then smooth in the
parameters and FD converges to the autodiff value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import combine, compile_scene, partition
from rust_ray_tracer_tpu.ops.camera import CameraData, make_camera
from rust_ray_tracer_tpu.ops.integrator import render_image


def cam():
    return make_camera(np.eye(3, 4, dtype=np.float32), 40.0, 1.0)


def render_loss(sd, key, w=8, h=8, spp=2, depth=3):
    img = render_image(sd, w, h, spp, key, depth=depth, chunk_size=64)
    return jnp.mean(img)


def fd_check(loss_of_theta, theta0, eps, rtol=5e-2, atol=1e-5):
    g = jax.grad(loss_of_theta)(jnp.float32(theta0))
    lp = float(loss_of_theta(jnp.float32(theta0 + eps)))
    lm = float(loss_of_theta(jnp.float32(theta0 - eps)))
    fd = (lp - lm) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=rtol, atol=atol)
    return float(g)


class TestMaterialGrads:
    def test_albedo_grad(self):
        key = jax.random.PRNGKey(0)
        base = compile_scene(S.Scene(cam(), [
            S.Sphere((0, 0, -4), 1.5, S.Lambertian.from_rgb(0.5, 0.5, 0.5)),
        ], [], (0.8, 0.8, 0.8)))

        def loss(a):
            sd = base._replace(tex_color=base.tex_color.at[..., :].set(a))
            return render_loss(sd, key)

        g = fd_check(loss, 0.5, 1e-3)
        assert g > 0  # brighter albedo -> brighter image

    def test_emission_grad(self):
        key = jax.random.PRNGKey(1)
        base = compile_scene(S.Scene(cam(), [
            S.XYRect(-2.0, 2.0, -2.0, 2.0, -4.0,
                     S.DiffuseLight.from_color((3, 3, 3))),
        ], [], (0, 0, 0)))
        tid = int(np.asarray(base.mat_tex)[
            int(np.asarray(base.quad_mat)[0])])

        def loss(e):
            sd = base._replace(
                tex_color=base.tex_color.at[tid].set(jnp.full(3, e)))
            return render_loss(sd, key)

        g = fd_check(loss, 3.0, 1e-2)
        # d mean / d emit: every pixel sees the emitter head-on
        assert g > 0

    def test_metal_albedo_grad(self):
        key = jax.random.PRNGKey(2)

        def loss(a):
            base = compile_scene(S.Scene(cam(), [
                S.XYRect(-4.0, 4.0, -4.0, 4.0, -4.0, S.Metal((0.5, 0.5, 0.5), 0.0)),
            ], [], (0.9, 0.9, 0.9)))
            tid = int(np.asarray(base.mat_tex)[0])
            sd = base._replace(
                tex_color=base.tex_color.at[:].set(
                    jnp.broadcast_to(a, base.tex_color.shape)))
            return render_loss(sd, key)

        fd_check(loss, 0.5, 1e-3)


class TestGeometryGrads:
    def test_vertex_grad(self):
        """Gradient w.r.t. a triangle vertex position (shadow-free interior
        derivative through t/normal, not edge discontinuities)."""
        key = jax.random.PRNGKey(3)
        base = compile_scene(S.Scene(cam(), [
            S.Triangle((-2, -2, -4), (2, -2, -4), (0, 2, -4),
                       S.DiffuseLight.from_color((2, 2, 2))),
        ], [], (0.1, 0.1, 0.1)))

        def loss(z):
            v0 = jnp.asarray([-2.0, -2.0, 0.0]) + jnp.array([0, 0, 1.0]) * z
            sd = base._replace(tri_v0=base.tri_v0.at[0].set(v0))
            return render_loss(sd, key, depth=1)

        g = jax.grad(loss)(jnp.float32(-4.0))
        assert np.isfinite(float(g))

    def test_sphere_radius_grad_smooth_region(self):
        """Radius affects hit point / normal of interior rays."""
        key = jax.random.PRNGKey(4)
        base = compile_scene(S.Scene(cam(), [
            S.Sphere((0, 0, -4), 1.5, S.Lambertian.from_rgb(0.6, 0.3, 0.2)),
            S.XYRect(-9.0, 9.0, -9.0, 9.0, -9.0,
                     S.DiffuseLight.from_color((1, 1, 1))),
        ], [], (0, 0, 0)))

        def loss(r):
            sd = base._replace(sph_r=base.sph_r.at[0].set(r))
            return render_loss(sd, key)

        g = jax.grad(loss)(jnp.float32(1.5))
        assert np.isfinite(float(g))


class TestCameraGrads:
    def test_fov_grad(self):
        key = jax.random.PRNGKey(5)
        world = [S.Sphere((0, 0, -4), 1.0,
                          S.Lambertian.from_rgb(0.9, 0.1, 0.1))]

        def loss(scale):
            c = CameraData(jnp.eye(3, 4), scale, jnp.float32(1.0),
                           jnp.float32(0.0), jnp.float32(1.0))
            sd = compile_scene(S.Scene(c, world, [], (0.0, 0.0, 0.0)))
            sd = sd._replace(camera=sd.camera._replace(scale=scale))
            return render_loss(sd, key)

        fd_check(loss, 0.4, 1e-3, rtol=0.1, atol=1e-4)

    def test_translation_grad(self):
        key = jax.random.PRNGKey(6)
        world = [S.XYRect(-1.0, 3.0, -2.0, 2.0, -4.0,
                          S.DiffuseLight.from_color((1, 1, 1)))]
        base = compile_scene(S.Scene(cam(), world, [], (0, 0, 0)))

        def loss(tx):
            c2w = jnp.eye(3, 4).at[0, 3].set(tx)
            sd = base._replace(camera=base.camera._replace(c2w=c2w))
            return render_loss(sd, key, depth=1)

        g = jax.grad(loss)(jnp.float32(0.0))
        assert np.isfinite(float(g))


def test_partition_combine_roundtrip():
    sd = compile_scene(S.Scene(cam(), [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.5, 0.5, 0.5)),
    ], [], (0.5, 0.5, 0.5)))
    diff, static = partition(sd)
    back = combine(diff, static)
    for a, b in zip(jax.tree.leaves(sd), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # every float leaf is in diff, every int/bool leaf in static
    assert all(jnp.issubdtype(x.dtype, jnp.floating)
               for x in jax.tree.leaves(diff))


def test_grad_through_full_scene_pytree():
    """jax.grad over the whole differentiable partition at once — the
    training-style entry: grads for every float leaf are finite."""
    key = jax.random.PRNGKey(8)
    sd = compile_scene(S.Scene(cam(), [
        S.Sphere((0, 0, -4), 1.0, S.Lambertian.from_rgb(0.4, 0.5, 0.6)),
        S.XYRect(-3.0, 3.0, -3.0, 3.0, 4.0,
                 S.DiffuseLight.from_color((4, 4, 4))),
    ], [S.XZRect(-1.0, 1.0, -1.0, 1.0, 3.9,
                 S.DiffuseLight.from_color((4, 4, 4)))], (0.05, 0.05, 0.05)))
    diff, static = partition(sd)

    def loss(d):
        return render_loss(combine(d, static), key)

    grads = jax.grad(loss)(diff)
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()


class TestMetalRoughSpheres:
    """BASELINE config 4: per-sphere roughness/metallic grads on the
    MetalRoughSpheres glTF grid (path replay with detached sampling).

    The asset's own camera/framing is unusable (the grid spans ~6mm at
    the origin with no camera node; the reference importer couldn't load
    the file at all — external .bin + u32 indices), so the test frames
    it explicitly, subsamples the 1M-triangle mesh to keep the CPU
    brute-force path tractable, and adds a lamp so roughness has a
    direction-dependent signal to differentiate against."""

    @pytest.mark.slow
    def test_roughness_and_basecolor_grads(self):
        import os
        path = ("/root/reference/assets/MetalRoughSpheres/"
                "MetalRoughSpheres.gltf")
        if not os.path.exists(path):
            pytest.skip("MetalRoughSpheres not present")
        from rust_ray_tracer_tpu.models.gltf import load_gltf_scene
        sc = load_gltf_scene(path, 1.0)
        # the asset is authored at sub-mm scale, where the reference's own
        # det epsilon (1e-5, triangle.rs:42) rejects every triangle;
        # scale a two-sphere slice up to unit size for the gradient check
        SCALE = 1000.0
        sub = [S.Triangle(np.asarray(t.v0) * SCALE,
                          np.asarray(t.v1) * SCALE,
                          np.asarray(t.v2) * SCALE, t.material)
               for t in (sc.world[:12000] + sc.world[74200:86200])]
        vs = np.array([t.v0 for t in sub], np.float32)
        mn, mx = vs.min(0), vs.max(0)
        ctr, ext = (mn + mx) / 2, float((mx - mn).max())
        lamp = S.XZRect(ctr[0] - ext, ctr[0] + ext, ctr[2] - ext,
                        ctr[2] + ext, mx[1] + ext,
                        S.DiffuseLight.from_color((6, 6, 6)))
        world = sub + [lamp]
        camera = make_camera(
            np.array([[1, 0, 0, ctr[0]], [0, 1, 0, ctr[1]],
                      [0, 0, 1, mx[2] + ext * 1.5]], np.float32),
            45.0, 1.0)
        base = compile_scene(S.Scene(camera, world, [lamp],
                             (0.05,) * 3))
        key = jax.random.PRNGKey(0)

        def render(sd):
            return render_image(sd, 16, 16, 2, key, depth=3,
                                chunk_size=256)

        img = np.asarray(render(base))
        hit_frac = (np.abs(img - 0.05).max(-1) > 1e-3).mean()
        assert hit_frac > 0.08, f"grid not visible ({hit_frac})"

        g_fuzz = np.asarray(jax.grad(
            lambda f: jnp.mean(render(base._replace(mat_fuzz=f))))(
                base.mat_fuzz))
        assert np.isfinite(g_fuzz).all()
        # roughness reaches the estimator only through metal->diffuse->
        # light-branch chains (see test_fuzz_grad_mechanism), which this
        # sparse sampling may not hit — finiteness is the contract here

        g_alb = np.asarray(jax.grad(
            lambda t: jnp.mean(render(base._replace(tex_color=t))))(
                base.tex_color))
        assert np.isfinite(g_alb).all()
        assert (np.abs(g_alb).sum(1) != 0).sum() >= 2  # per-material


def test_fuzz_grad_mechanism():
    """Roughness gradients flow through metal -> diffuse -> light-mixture
    chains: the mixture pdf/lights-sample depend smoothly on the hit
    point, which depends on fuzz through the perturbed reflection."""
    from rust_ray_tracer_tpu.ops.integrator import trace_rays

    lamp = S.Sphere((0, 2.0, -4), 0.6, S.DiffuseLight.from_color((10,) * 3))
    base = compile_scene(S.Scene(cam(), [
        S.XZRect(-4.0, 4.0, -9.0, -0.5, -1.0, S.Metal((0.9,) * 3, 0.3)),
        S.XZRect(-4.0, 4.0, -9.0, -0.5, 3.0,
                 S.Lambertian.from_rgb(0.6, 0.6, 0.6)),
        lamp], [lamp], (0.1, 0.1, 0.1)))
    key = jax.random.PRNGKey(0)
    n = 256
    o = jnp.zeros((n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.8, -0.9, -1.0]), (n, 3))
    t = jnp.zeros(n)

    def loss(v):
        sd = base._replace(mat_fuzz=base.mat_fuzz.at[0].set(v))
        return jnp.mean(trace_rays(sd, o, d, t, key, 3))

    g = float(jax.grad(loss)(jnp.float32(0.3)))
    assert np.isfinite(g) and g != 0.0
    # same sign and order as the common-random-numbers secant
    fd = (float(loss(jnp.float32(0.4))) - float(loss(jnp.float32(0.3)))) / 0.1
    assert np.sign(g) == np.sign(fd)


def test_sphere_pole_uv_grads_finite():
    """Regression: a ray hitting a sphere's pole saturates the UV
    arccos/arctan2 inputs exactly; their infinite/NaN derivatives times a
    zero cotangent used to poison every upstream gradient (found when an
    inverse-rendering run went NaN)."""
    from rust_ray_tracer_tpu.ops.integrator import trace_rays

    base = compile_scene(S.Scene(cam(), [
        S.Sphere((0, -3, -4), 1.0, S.Lambertian.from_rgb(0.6, 0.5, 0.4)),
    ], [], (0.4, 0.4, 0.4)))
    # straight down onto the north pole: hit normal == (0,1,0) exactly
    o = jnp.asarray([[0.0, 0.0, -4.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])

    def loss(dd):
        L = trace_rays(combine(dd, partition(base)[1]), o, d,
                       jnp.zeros(1), jax.random.PRNGKey(0), 2)
        return jnp.sum(L)

    g = jax.grad(loss)(partition(base)[0])
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def _inward_box(lo, hi, mat):
    """12 triangles wound so cross(e1,e2) points INTO the box: hits from
    inside are front faces, so a DiffuseLight material emits
    (material/mod.rs:171-194 front-face rule)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi

    def v(x, y, z):
        return np.array([x, y, z], np.float32)

    faces = [
        (v(x0, y0, z0), v(0, y1 - y0, 0), v(0, 0, z1 - z0)),
        (v(x1, y0, z0), v(0, 0, z1 - z0), v(0, y1 - y0, 0)),
        (v(x0, y0, z0), v(0, 0, z1 - z0), v(x1 - x0, 0, 0)),
        (v(x0, y1, z0), v(x1 - x0, 0, 0), v(0, 0, z1 - z0)),
        (v(x0, y0, z0), v(x1 - x0, 0, 0), v(0, y1 - y0, 0)),
        (v(x0, y0, z1), v(0, y1 - y0, 0), v(x1 - x0, 0, 0)),
    ]
    tris = []
    for q, u, w in faces:
        tris.append(S.Triangle(q, q + u, q + w, mat))
        tris.append(S.Triangle(q + u + w, q + w, q + u, mat))
    return tris


class TestMetalRoughSpheresFD:
    """Config-4 quantitative gradient evidence: FD-vs-autodiff ALLCLOSE
    (rtol <= 5e-2) on the actual MetalRoughSpheres roughness (fuzz) and
    baseColor parameters (the metallic->Metal mapping under test:
    gltf.rs:147-168 / models/gltf.py).

    Estimator discontinuities (silhouette crossings) are the classic
    failure mode of detached-sampling gradients, so the harness makes
    the integrand smooth BY CONSTRUCTION: the sphere grid sits inside a
    marble-emissive dome (Perlin turbulence — smooth everywhere), scene
    normalized to ~unit extent so hit-point motion per unit fuzz stays
    below the turbulence wavelength, and both AD and central FD average
    the same fixed key set (common random numbers)."""

    KEYS = 8
    N = 8192
    # two complete metal spheres: fuzz 1/6 at tris [84800:95400),
    # fuzz 1/3 at [243800:254400). Each gets ITS OWN scene: with any
    # second sphere present, the scattered cone can graze its
    # silhouette, whose discontinuous fuzz-dependence FD picks up but
    # detached-sampling AD cannot (measured: a shared two-sphere scene
    # left a persistent ~20% AD/FD gap; isolated scenes close it).
    SPHERES = [(84800, 95400), (243800, 254400)]

    @pytest.fixture(scope="class")
    def rigs(self):
        import os
        path = ("/root/reference/assets/MetalRoughSpheres/"
                "MetalRoughSpheres.gltf")
        if not os.path.exists(path):
            pytest.skip("MetalRoughSpheres not present")
        from rust_ray_tracer_tpu.models.gltf import load_gltf_scene
        from rust_ray_tracer_tpu.ops.integrator import trace_rays

        sc = load_gltf_scene(path, 1.0)
        keys = [jax.random.PRNGKey(i) for i in range(self.KEYS)]
        camera = make_camera(np.eye(3, 4, dtype=np.float32), 45.0, 1.0)
        rng = np.random.default_rng(7)
        out = []
        for a, b in self.SPHERES:
            sub = list(sc.world[a:b])  # one full sphere: convex, no
            vs = np.array([t.v0 for t in sub], np.float32)  # silhouettes
            mn, mx = vs.min(0), vs.max(0)
            scale = 1.0 / float((mx - mn).max())   # ~unit extent
            sub = [S.Triangle(np.asarray(t.v0) * scale,
                              np.asarray(t.v1) * scale,
                              np.asarray(t.v2) * scale, t.material)
                   for t in sub]
            mn, mx = mn * scale, mx * scale
            ctr = (mn + mx) / 2
            # tight dome (margin 0.4): a short hit-point lever arm keeps
            # the marble integrand smooth at the FD eps scale — measured
            # AD/FD rel. err 0.012/0.026 here vs 0.141/0.087 at margin
            # 1.0 (the eye sits OUTSIDE the box; its walls are inward-
            # wound single-sided tris, so primaries pass through)
            marble = S.DiffuseLight(S.Noise(0.7))
            dome = _inward_box(mn - 0.4, mx + 0.4, marble)
            base = compile_scene(S.Scene(camera, sub + dome, [],
                                         (0, 0, 0)))

            eye = ctr + np.array([0.0, 0.0, (mx - mn)[2] / 2 + 0.8],
                                 np.float32)
            # aim only at the camera-facing cap (cos >= 0.55):
            # reflected·normal >= 0.55 and |fuzz·ball| <= 1/3 keeps the
            # fuzzed direction above the surface for EVERY draw, so the
            # metal_ok absorption boundary (mod.rs:99) — a discontinuous
            # fuzz-dependence AD cannot see — is never crossed.
            svs = vs * scale
            nrm = svs - ctr
            nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
            to_eye = eye[None, :] - svs   # exact per-vertex incidence
            to_eye = to_eye / np.linalg.norm(to_eye, axis=1,
                                             keepdims=True)
            cap_vs = svs[(nrm * to_eye).sum(1) >= 0.55]
            targets = cap_vs[rng.integers(0, len(cap_vs), self.N)]
            o = jnp.broadcast_to(jnp.asarray(eye), (self.N, 3))
            d = jnp.asarray(targets - np.asarray(o), jnp.float32)
            t = jnp.zeros(self.N)

            fuzz_ids = np.nonzero(np.asarray(base.mat_fuzz) > 0)[0]
            assert len(fuzz_ids) == 1      # exactly this sphere's metal

            def loss_k(sd, key, o=o, d=d, t=t):
                return jnp.mean(trace_rays(sd, o, d, t, key, 2))

            out.append((base, loss_k, int(fuzz_ids[0])))
        return out, keys

    @pytest.mark.slow
    def test_roughness_fd_allclose(self, rigs):
        rig_list, keys = rigs
        for base, loss_k, i in rig_list:
            lk = jax.jit(loss_k)
            gk = jax.jit(jax.grad(
                lambda f, key, base=base, loss_k=loss_k:
                    loss_k(base._replace(mat_fuzz=f), key)))

            g = np.mean([np.asarray(gk(base.mat_fuzz, k))
                         for k in keys], 0)
            eps = 0.002

            def loss(v):
                sd = base._replace(
                    mat_fuzz=base.mat_fuzz.at[i].set(jnp.float32(v)))
                return float(np.mean([float(lk(sd, k)) for k in keys]))

            f0 = float(base.mat_fuzz[i])
            fd = (loss(f0 + eps) - loss(f0 - eps)) / (2 * eps)
            assert np.isfinite(g[i]) and fd != 0.0
            np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=2e-4)

    @pytest.mark.slow
    def test_basecolor_fd_allclose(self, rigs):
        rig_list, keys = rigs
        for base, loss_k, i in rig_list:
            lk = jax.jit(loss_k)
            gk = jax.jit(jax.grad(
                lambda tc, key, base=base, loss_k=loss_k:
                    loss_k(base._replace(tex_color=tc), key)))

            g = np.mean([np.asarray(gk(base.tex_color, k))
                         for k in keys], 0)
            eps = 0.01
            ti = int(base.mat_tex[i])  # material -> its solid texture

            def loss(v):
                tc = base.tex_color.at[ti, 0].set(jnp.float32(v))
                return float(np.mean(
                    [float(lk(base._replace(tex_color=tc), k))
                     for k in keys]))

            c0 = float(base.tex_color[ti, 0])
            fd = (loss(c0 + eps) - loss(c0 - eps)) / (2 * eps)
            assert fd > 0.0            # more albedo -> more radiance
            np.testing.assert_allclose(g[ti, 0], fd, rtol=5e-2)
