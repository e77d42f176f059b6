"""Intersection kernels vs NumPy oracles of the reference math.

Oracles: sphere quadratic ``sphere.rs:52-95``, Möller–Trumbore
``triangle.rs:38-69``, aarect plane-slab ``aarect.rs:38-67``, constant
medium ``constant_medium.rs:46-80``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import compile_scene
from rust_ray_tracer_tpu.ops.intersect import intersect

MAT = S.Lambertian.from_rgb(0.5, 0.5, 0.5)


def make(world, lights=(), background=(0, 0, 0)):
    from rust_ray_tracer_tpu.ops.camera import make_camera
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 30.0, 1.0)
    return compile_scene(S.Scene(cam, list(world), list(lights), background))


def run(scene, o, d, time=None, med_u=None):
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    t = (jnp.zeros(o.shape[0]) if time is None
         else jnp.asarray(time, jnp.float32).reshape(-1))
    return intersect(scene, o, d, t, med_u)


class TestSphere:
    def test_two_roots(self):
        sc = make([S.Sphere((0, 0, -5), 1.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 0, -1])
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1],
                                   atol=1e-5)

    def test_inside_far_root(self):
        # origin inside the sphere: near root < t_min, take far root
        sc = make([S.Sphere((0, 0, 0), 2.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 0, -1])
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
        # outward geometric normal (the reference never flips by face)
        np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, -1],
                                   atol=1e-5)

    def test_miss(self):
        sc = make([S.Sphere((0, 0, -5), 1.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 1, 0])
        assert not bool(h.hit[0])
        assert not np.isfinite(float(h.t[0]))

    def test_unnormalized_direction(self):
        # t scales with |d|: the reference solves the quadratic in the raw d
        sc = make([S.Sphere((0, 0, -10), 1.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 0, -2])
        np.testing.assert_allclose(float(h.t[0]), 4.5, rtol=1e-5)

    def test_uv_oracle(self):
        # hit point (-1,0,0) on unit sphere at origin -> u=0 or 1, v=0.5;
        # front hit uses the unit normal for UV (sphere.rs:66-69)
        sc = make([S.Sphere((0, 0, 0), 1.0, MAT)])
        h = run(sc, [-3, 0, 0], [1, 0, 0])
        # normal (-1,0,0): theta=acos(-0)=pi/2 -> v=0.5;
        # phi=atan2(-0,-1)+pi=pi -> u=0.5... compute oracle directly:
        n = np.array([-1.0, 0.0, 0.0])
        theta = np.arccos(-n[1])
        phi = np.arctan2(-n[2], n[0]) + np.pi
        np.testing.assert_allclose(float(h.u[0]), phi / (2 * np.pi),
                                   atol=1e-5)
        np.testing.assert_allclose(float(h.v[0]), theta / np.pi, atol=1e-5)

    def test_moving_sphere_lerp(self):
        sc = make([S.MovingSphere((0, 0, -5), (2, 0, -5), 0.0, 1.0, 1.0,
                                  MAT)])
        h0 = run(sc, [0, 0, 0], [0, 0, -1], time=[0.0])
        h1 = run(sc, [2, 0, 0], [0, 0, -1], time=[1.0])
        hm = run(sc, [1, 0, 0], [0, 0, -1], time=[0.5])
        for h in (h0, h1, hm):
            assert bool(h.hit[0])
            np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-4)


class TestTriangle:
    def oracle_mt(self, orig, d, v0, v1, v2, double=False):
        """Möller–Trumbore per triangle.rs:38-69 (with its t>=1e-4 window)."""
        e1, e2 = v1 - v0, v2 - v0
        pvec = np.cross(d, e2)
        det = np.dot(e1, pvec)
        if (not double and det < 1e-5) or abs(det) < 1e-5:
            return None
        inv = 1.0 / det
        tvec = orig - v0
        u = np.dot(tvec, pvec) * inv
        if u < 0 or u > 1:
            return None
        qvec = np.cross(tvec, e1)
        v = np.dot(d, qvec) * inv
        if v < 0 or v >= 1 - u:
            return None
        t = np.dot(e2, qvec) * inv
        if t < 1e-4:
            return None
        return t, u, v

    @pytest.mark.parametrize("seed", range(5))
    def test_random_tris_match_oracle(self, seed):
        rng = np.random.default_rng(seed)
        v = rng.standard_normal((3, 3)).astype(np.float32)
        tri = S.Triangle(v[0], v[1], v[2], MAT)
        sc = make([tri])
        o = rng.standard_normal((64, 3)).astype(np.float32) * 2
        d = rng.standard_normal((64, 3)).astype(np.float32)
        h = run(sc, o, d)
        for i in range(64):
            got = self.oracle_mt(o[i], d[i], *v)
            if got is None:
                assert not bool(h.hit[i]), f"ray {i}: spurious hit"
            else:
                assert bool(h.hit[i]), f"ray {i}: missed"
                np.testing.assert_allclose(float(h.t[i]), got[0], rtol=2e-3,
                                           atol=2e-4)
                np.testing.assert_allclose(float(h.u[i]), got[1], atol=5e-3)
                np.testing.assert_allclose(float(h.v[i]), got[2], atol=5e-3)

    def test_backface_cull(self):
        v = np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32)
        sc_front = make([S.Triangle(v[0], v[1], v[2], MAT)])
        # from +z the winding gives det>0 for direction -z
        h = run(sc_front, [0.2, 0.2, 0], [0, 0, -1])
        assert bool(h.hit[0])
        # flip winding -> det<0 -> culled unless double_sided
        sc_back = make([S.Triangle(v[1], v[0], v[2], MAT)])
        h = run(sc_back, [0.2, 0.2, 0], [0, 0, -1])
        assert not bool(h.hit[0])
        sc_double = make([S.Triangle(v[1], v[0], v[2], MAT,
                                     double_sided=True)])
        h = run(sc_double, [0.2, 0.2, 0], [0, 0, -1])
        assert bool(h.hit[0])

    def test_normal_sign_follows_det(self):
        # geometric normal = normalize(cross(e1,e2)) * sign(det)
        # (triangle.rs:58) -> always faces the incoming side that passed cull
        v = np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32)
        sc = make([S.Triangle(v[0], v[1], v[2], MAT)])
        h = run(sc, [0.2, 0.2, 0], [0, 0, -1])
        np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1],
                                   atol=1e-5)


class TestQuad:
    def test_xyrect(self):
        # XYRect z=k plane (aarect.rs:38-67)
        sc = make([S.XYRect(-1.0, 1.0, -1.0, 1.0, -3.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 0, -1])
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1],
                                   atol=1e-5)
        # normal flips from the other side (faces the ray origin)
        h2 = run(sc, [0, 0, -6], [0, 0, 1])
        np.testing.assert_allclose(np.asarray(h2.normal[0]), [0, 0, -1],
                                   atol=1e-5)

    def test_uv_coords(self):
        sc = make([S.XYRect(0.0, 2.0, 0.0, 4.0, -1.0, MAT)])
        h = run(sc, [0.5, 1.0, 0], [0, 0, -1])
        np.testing.assert_allclose(float(h.u[0]), 0.25, atol=1e-5)
        np.testing.assert_allclose(float(h.v[0]), 0.25, atol=1e-5)

    def test_bounds(self):
        sc = make([S.XZRect(0.0, 1.0, 0.0, 1.0, -2.0, MAT)])
        assert bool(run(sc, [0.5, 0, 0.5], [0, -1, 0]).hit[0])
        assert not bool(run(sc, [1.5, 0, 0.5], [0, -1, 0]).hit[0])

    def test_rotated_cuboid_face(self):
        # RotateY(45°) of a unit cube: ray along x hits the rotated face
        # at distance sqrt(2)/2 from center plane
        box = S.RotateY(S.Cuboid((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), MAT),
                        45.0)
        sc = make([box])
        # at z=0.2 the rotated cross-section boundary is |x|+|z| = sqrt(2)/2
        h = run(sc, [-3, 0, 0.2], [1, 0, 0])
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]),
                                   3 - (np.sqrt(2) / 2 - 0.2), rtol=1e-4)


class TestClosest:
    def test_cross_kind_closest(self):
        sc = make([
            S.Sphere((0, 0, -10), 1.0, MAT),
            S.XYRect(-5.0, 5.0, -5.0, 5.0, -5.0, MAT),
            S.Triangle((-1, -1, -3), (1, -1, -3), (0, 1, -3), MAT,
                       double_sided=True),
        ])
        h = run(sc, [0, 0, 0], [0, 0, -1])
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)  # triangle

    def test_t_max_shrink(self):
        # two spheres along the ray: nearer one wins
        sc = make([S.Sphere((0, 0, -10), 1.0, MAT),
                   S.Sphere((0, 0, -4), 1.0, MAT)])
        h = run(sc, [0, 0, 0], [0, 0, -1])
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)


class TestMedium:
    def test_free_flight_oracle(self):
        # ray through a r=1 sphere at origin, density rho: scatter at
        # t1 + (-1/rho * ln U)/|d| if within the chord
        rho = 2.0
        med = S.ConstantMedium.from_color(
            S.Sphere((0, 0, -5), 1.0, S.Dielectric(1.5)), rho, (1, 0, 0))
        sc = make([med])
        u = 0.3
        med_u = jnp.full((1, sc.n_media), u, jnp.float32)
        h = run(sc, [0, 0, 0], [0, 0, -1], med_u=med_u)
        expect = 4.0 + (-1.0 / rho) * np.log(u)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), expect, rtol=1e-4)

    def test_flight_longer_than_chord_misses(self):
        med = S.ConstantMedium.from_color(
            S.Sphere((0, 0, -5), 1.0, S.Dielectric(1.5)), 0.1, (1, 0, 0))
        sc = make([med])
        med_u = jnp.full((1, sc.n_media), 1e-6, jnp.float32)  # huge flight
        h = run(sc, [0, 0, 0], [0, 0, -1], med_u=med_u)
        assert not bool(h.hit[0])

    def test_box_boundary_oracle(self):
        """Smoke in a box (constant_medium.rs:46-80 with a Cuboid
        boundary): entry/exit are the slab interval, scatter at
        t1 + (-1/rho·ln U)/|d|."""
        rho = 2.0
        med = S.ConstantMedium.from_color(
            S.Cuboid((-1, -1, -6), (1, 1, -4), S.Dielectric(1.5)),
            rho, (1, 0, 0))
        sc = make([med])
        u = 0.3
        med_u = jnp.full((1, sc.n_media), u, jnp.float32)
        h = run(sc, [0, 0, 0], [0, 0, -1], med_u=med_u)
        expect = 4.0 + (-1.0 / rho) * np.log(u)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), expect, rtol=1e-4)
        # fixed (1,0,0) medium normal (constant_medium.rs:72)
        np.testing.assert_allclose(np.asarray(h.normal[0]), [1, 0, 0])

    def test_rotated_translated_box_boundary(self):
        """RotateY(45°) square prism crossed along x: the diagonal chord
        through the center has length 2·r√2... computed exactly below."""
        rho = 4.0
        box = S.Translate(
            S.RotateY(S.Cuboid((-1, -1, -1), (1, 1, 1),
                               S.Dielectric(1.5)), 45.0),
            (5.0, 0.0, 0.0))
        med = S.ConstantMedium.from_color(box, rho, (1, 0, 0))
        sc = make([med])
        u = 0.5
        med_u = jnp.full((1, sc.n_media), u, jnp.float32)
        # ray along +x through the prism center: hits the rotated box's
        # corner-to-corner section; entry at 5 - sqrt(2), exit 5 + sqrt(2)
        h = run(sc, [0, 0, 0], [1, 0, 0], med_u=med_u)
        t1 = 5.0 - np.sqrt(2.0)
        expect = t1 + (-1.0 / rho) * np.log(u)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), expect, rtol=1e-4)

    def test_box_flight_longer_than_chord_misses(self):
        med = S.ConstantMedium.from_color(
            S.Cuboid((-1, -1, -6), (1, 1, -4), S.Dielectric(1.5)),
            0.1, (1, 0, 0))
        sc = make([med])
        med_u = jnp.full((1, sc.n_media), 1e-6, jnp.float32)
        h = run(sc, [0, 0, 0], [0, 0, -1], med_u=med_u)
        assert not bool(h.hit[0])

    def test_ray_missing_box_boundary(self):
        med = S.ConstantMedium.from_color(
            S.Cuboid((-1, -1, -6), (1, 1, -4), S.Dielectric(1.5)),
            50.0, (1, 0, 0))
        sc = make([med])
        med_u = jnp.full((1, sc.n_media), 0.5, jnp.float32)
        h = run(sc, [0, 3, 0], [0, 0, -1], med_u=med_u)  # passes above
        assert not bool(h.hit[0])

    @staticmethod
    def _cube_mesh(mn, mx, double_sided=True):
        """The 12-triangle cube (vertex triples), for Mesh boundaries."""
        mn, mx = np.asarray(mn, np.float64), np.asarray(mx, np.float64)
        corners = [(mn[0] if i & 1 == 0 else mx[0],
                    mn[1] if i & 2 == 0 else mx[1],
                    mn[2] if i & 4 == 0 else mx[2]) for i in range(8)]
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
        tris = []
        for a, b, c, d in quads:
            tris.append((corners[a], corners[b], corners[c]))
            tris.append((corners[a], corners[c], corners[d]))
        return S.Mesh(tris, double_sided=double_sided)

    def test_mesh_boundary_matches_cuboid(self):
        """A 12-triangle cube Mesh boundary scatters exactly like the
        Cuboid (MED_POLY) boundary — entry/exit via the reference's
        two-hit queries (constant_medium.rs:47-49)."""
        rho, u = 2.0, 0.3
        box = S.ConstantMedium.from_color(
            S.Cuboid((-1, -1, -6), (1, 1, -4), S.Dielectric(1.5)),
            rho, (1, 0, 0))
        mesh = S.ConstantMedium.from_color(
            self._cube_mesh((-1, -1, -6), (1, 1, -4)), rho, (1, 0, 0))
        o, d = [0.2, -0.3, 0], [0.05, 0.02, -1]
        ts = []
        for med in (box, mesh):
            sc = make([med])
            med_u = jnp.full((1, sc.n_media), u, jnp.float32)
            h = run(sc, o, d, med_u=med_u)
            assert bool(h.hit[0])
            ts.append(float(h.t[0]))
            np.testing.assert_allclose(np.asarray(h.normal[0]), [1, 0, 0])
        np.testing.assert_allclose(ts[0], ts[1], rtol=1e-4)

    def test_mesh_boundary_under_transform(self):
        """Translate/RotateY wrap a Mesh boundary like any other."""
        rho, u = 2.0, 0.5
        prism = S.Translate(
            S.RotateY(self._cube_mesh((-1, -1, -1), (1, 1, 1)), 45.0),
            (5.0, 0.0, 0.0))
        sc = make([S.ConstantMedium.from_color(prism, rho, (1, 0, 0))])
        med_u = jnp.full((1, sc.n_media), u, jnp.float32)
        h = run(sc, [0, 0, 0], [1, 0, 0], med_u=med_u)
        t1 = 5.0 - np.sqrt(2.0)
        expect = t1 + (-1.0 / rho) * np.log(u)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), expect, rtol=1e-4)

    def test_single_sided_mesh_boundary_has_no_exit(self):
        """Single-sided closed mesh: the exit query backface-culls the
        far face (triangle.rs facing rule), so no medium — matching the
        reference's two-hit scheme exactly."""
        mesh = self._cube_mesh((-1, -1, -6), (1, 1, -4),
                               double_sided=False)
        sc = make([S.ConstantMedium.from_color(mesh, 50.0, (1, 0, 0))])
        med_u = jnp.full((1, sc.n_media), 0.5, jnp.float32)
        h = run(sc, [0, 0, 0], [0, 0, -1], med_u=med_u)
        assert not bool(h.hit[0])

    def test_mesh_as_world_object(self):
        """Mesh also works as plain geometry (expands to Triangles)."""
        mesh = self._cube_mesh((-1, -1, -6), (1, 1, -4))
        mesh.material = MAT
        sc = make([mesh])
        assert sc.n_tris >= 12
        h = run(sc, [0, 0, 0], [0, 0, -1])
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)


class TestFlipFace:
    def test_flip_quirk(self):
        # normal.y forced to -|y| (geometry/mod.rs:226-230)
        sc = make([S.FlipFace(S.XZRect(-1.0, 1.0, -1.0, 1.0, 2.0, MAT))])
        h = run(sc, [0, 0, 0], [0, 1, 0])
        assert bool(h.hit[0])
        np.testing.assert_allclose(np.asarray(h.normal[0]), [0, -1, 0],
                                   atol=1e-5)


def test_differentiable_t_wrt_vertex():
    """Gradient flows through SceneData leaves (compile_scene is host-side;
    differentiation happens on the compiled arrays, scene.py:21-23)."""
    v = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    base = make([S.Triangle(v[0], v[1], v[2], MAT)])

    def t_of_z(z):
        # move all three vertices' plane: v0.z = z, keep edges in-plane
        sc = base._replace(tri_v0=base.tri_v0.at[0, 2].set(z))
        h = run(sc, [0, 0, 0], [0, 0, -1])
        return h.t[0]

    g = jax.grad(t_of_z)(jnp.float32(-3.0))
    eps = 1e-2
    fd = (float(t_of_z(jnp.float32(-3.0 + eps)))
          - float(t_of_z(jnp.float32(-3.0 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-2, atol=1e-3)


def test_kind_rows_big_branch_matches_fused():
    """intersect_select's two gather layouts — the fused [P, 11] row
    table (small meshes) and the per-kind gathers (>FUSED_ROW_MAX, e.g.
    1M-tri meshes) — must produce an identical Select. Forced by
    lowering the threshold to 0."""
    import rust_ray_tracer_tpu.ops.intersect as it

    rng = np.random.default_rng(7)
    mats = [S.Lambertian.from_rgb(0.6, 0.3, 0.2),
            S.Metal((0.9, 0.8, 0.7), 0.2),
            S.Dielectric(1.5)]
    world = []
    for i in range(60):
        v0 = rng.uniform(-4, 4, 3).astype(np.float32)
        v0[2] -= 6.0
        e = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
        world.append(S.Triangle(v0, v0 + e[0], v0 + e[1], mats[i % 3],
                                double_sided=bool(i % 2)))
    world.append(S.Sphere((0, 0, -5), 1.0, mats[1]))
    world.append(S.XZRect(-2, 2, -7, -3, -2.0, mats[0]))
    from rust_ray_tracer_tpu.ops.camera import make_camera
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    sd = compile_scene(S.Scene(cam, world, [], (0.2, 0.3, 0.4)))

    C = 300
    o = jnp.asarray(rng.uniform(-2, 2, (C, 3)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((C, 3)), jnp.float32)
    tt = jnp.zeros(C, jnp.float32)

    sel_fused = it.intersect_select(sd, o, d, tt)
    old = it.FUSED_ROW_MAX
    it.FUSED_ROW_MAX = 0
    try:
        sel_split = it.intersect_select(sd, o, d, tt)
    finally:
        it.FUSED_ROW_MAX = old
    for name in sel_fused._fields:
        a = np.asarray(getattr(sel_fused, name))
        b = np.asarray(getattr(sel_split, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
