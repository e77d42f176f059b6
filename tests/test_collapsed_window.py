"""Collapsed t-window invariant: a ray whose window is empty
(``t_max <= t_min``) must hit NOTHING, for every primitive kind, in
every search backend.

The wavefront integrator encodes dead lanes as ``t_max = -1`` and relies
on every search — the XLA candidate paths and the GPU triangle kernel
(run here in interpret mode) — rejecting every primitive kind under that
window (reference contract:
``geometry/mod.rs:137-153`` passes a shrinking ``t_max`` and
``constant_medium.rs:46-80`` clamps the exit by it). This file pins the
invariant per kind per backend, plus lane isolation: collapsing one
lane's window must not perturb any other lane's winner.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import compile_scene
from rust_ray_tracer_tpu.ops import intersect as it
from rust_ray_tracer_tpu.ops import tri_search
from rust_ray_tracer_tpu.ops.camera import make_camera
from rust_ray_tracer_tpu.ops.intersect import intersect, intersect_select

MAT = S.Lambertian.from_rgb(0.5, 0.5, 0.5)


def make(world):
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 30.0, 1.0)
    return compile_scene(S.Scene(cam, list(world), [], (0, 0, 0)))


# one (scene, hitting ray) per primitive kind; every ray hits with an
# open window so the collapsed result is a real rejection, not a miss
KINDS = {
    "sphere": (lambda: make([S.Sphere((0, 0, -5), 1.0, MAT)]),
               [0, 0, 0], [0, 0, -1]),
    "moving_sphere": (
        lambda: make([S.MovingSphere((0, 0, -5), (0, 1, -5),
                                     0.0, 1.0, 1.0, MAT)]),
        [0, 0, 0], [0, 0, -1]),
    "triangle": (
        lambda: make([S.Triangle((-1, -1, -4), (1, -1, -4), (0, 1, -4),
                                 MAT, double_sided=True)]),
        [0, 0, 0], [0, 0, -1]),
    "quad": (lambda: make([S.XZRect(-1, 1, -5, -3, -0.5, MAT)]),
             [0, 0, 0], [0, -0.5, -4]),
    "cuboid": (lambda: make([S.Cuboid((-1, -1, -6), (1, 1, -4), MAT)]),
               [0, 0, 0], [0, 0, -1]),
}


def _med_scene():
    return make([S.ConstantMedium.from_color(
        S.Sphere((0, 0, -5), 1.5, MAT), 10.0, (1, 1, 1))])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_xla_collapsed_window_rejects(kind):
    mk, o, d = KINDS[kind]
    sc = mk()
    o = jnp.asarray(o, jnp.float32).reshape(1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(1, 3)
    t = jnp.zeros(1)
    h_open = intersect(sc, o, d, t)
    assert bool(h_open.hit[0]), f"{kind}: setup ray must hit when open"
    h_dead = intersect(sc, o, d, t, t_max=jnp.asarray([-1.0]))
    assert not bool(h_dead.hit[0]), f"{kind}: collapsed window must miss"
    assert not np.isfinite(float(h_dead.t[0]))


def test_xla_collapsed_window_rejects_medium():
    sc = _med_scene()
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t = jnp.zeros(1)
    med_u = jnp.full((1, 1), 0.5)       # scatters well inside the chord
    h_open = intersect(sc, o, d, t, med_u=med_u)
    assert bool(h_open.hit[0]), "medium: setup ray must scatter when open"
    h_dead = intersect(sc, o, d, t, med_u=med_u,
                       t_max=jnp.asarray([-1.0]))
    assert not bool(h_dead.hit[0]), "medium: collapsed window must miss"


def _mixed_scene():
    return make([
        S.Triangle((-1, -1, -4), (1, -1, -4), (0, 1, -4), MAT,
                   double_sided=True),
        S.Sphere((3, 0, -5), 1.0, MAT),
        S.XZRect(2, 4, -6, -4, -0.5, MAT),
    ])


# 4 lanes: hits tri, hits sphere, hits quad (from above), stray
_O = [[0, 0, 0], [3, 0, 0], [3, 2, -5], [0, 5, 5]]
_D = [[0, 0, -1], [0, 0, -1], [0, -1, 0], [0, 1, 0]]


class TestSelectLaneIsolation:
    """intersect_select with mixed alive/dead windows: a collapsed lane
    misses, and collapsing it perturbs no other lane's winner."""

    def test_collapsed_rejects_and_lanes_isolated(self):
        sc = _mixed_scene()
        o = jnp.asarray(_O, jnp.float32)
        d = jnp.asarray(_D, jnp.float32)
        tm = jnp.zeros(4)
        open_w = jnp.full(4, jnp.inf)
        s0 = intersect_select(sc, o, d, tm, t_max=open_w)
        assert np.asarray(s0.hit)[:3].all(), "setup must hit"
        for dead in range(3):
            s = intersect_select(sc, o, d, tm, t_max=open_w.at[dead].set(-1))
            assert not bool(s.hit[dead]), f"lane {dead}"
            keep = np.asarray([i for i in range(4) if i != dead])
            for f in ("hit", "kind", "idx"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(s, f))[keep],
                    np.asarray(getattr(s0, f))[keep], err_msg=f)
        s = intersect_select(sc, o, d, tm, t_max=jnp.full(4, -1.0))
        assert not np.asarray(s.hit).any()

    @pytest.mark.parametrize("search", ["xla", "kernel"])
    def test_triangle_search_collapsed_lanes(self, search):
        """The triangle search alone, both forms: dead lanes miss and the
        live lane's winner is unchanged."""
        sc = _mixed_scene()
        o = jnp.asarray(_O, jnp.float32)
        d = jnp.asarray(_D, jnp.float32)
        t_min = jnp.full(4, 1e-4)
        coeffs = it._tri_coeffs(sc.tri_v0, sc.tri_e1, sc.tri_e2)
        if search == "xla":
            run = lambda tmax: it._tri_search_xla(  # noqa: E731
                sc, coeffs, o, d, t_min, tmax)
        else:
            tris = tri_search.pack_tris(*coeffs, sc.tri_double)
            run = lambda tmax: tri_search.search(  # noqa: E731
                o, d, t_min, tmax, tris, sc.tri_cluster_min,
                sc.tri_cluster_max, interpret=True)
        t0, i0 = run(jnp.full(4, jnp.inf))
        assert np.isfinite(float(t0[0])), "setup: lane 0 hits the triangle"
        t1, i1 = run(jnp.asarray([jnp.inf, -1.0, -1.0, -1.0]))
        assert float(t1[0]) == float(t0[0]) and int(i1[0]) == int(i0[0])
        assert not np.isfinite(np.asarray(t1[1:])).any()
        t2, _ = run(jnp.full(4, -1.0))
        assert not np.isfinite(np.asarray(t2)).any()


def test_select_collapsed_all_kinds_one_scene():
    """intersect_select end-to-end (XLA path): one scene containing every
    kind, every lane aimed at its kind, all windows collapsed -> no lane
    reports a hit and every kind is KIND_NONE."""
    sc = make([
        S.Sphere((0, 0, -5), 1.0, MAT),
        S.Triangle((2, -1, -4), (4, -1, -4), (3, 1, -4), MAT,
                   double_sided=True),
        S.XZRect(5, 7, -6, -4, -0.5, MAT),
        S.ConstantMedium.from_color(
            S.Sphere((9, 0, -5), 1.5, MAT), 10.0, (1, 1, 1)),
    ])
    o = jnp.asarray([[0, 0, 0], [3, 0, 0], [6, 2, -5], [9, 0, 0]],
                    jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, -1], [0, -1, 0], [0, 0, -1]],
                    jnp.float32)
    tm = jnp.zeros(4)
    med_u = jnp.full((4, 1), 0.5)
    sel_open = intersect_select(sc, o, d, tm, med_u=med_u)
    assert np.asarray(sel_open.hit).all(), "setup: every lane must hit"
    sel = intersect_select(sc, o, d, tm, med_u=med_u,
                           t_max=jnp.full(4, -1.0))
    assert not np.asarray(sel.hit).any()
    from rust_ray_tracer_tpu.ops.intersect import KIND_NONE
    np.testing.assert_array_equal(np.asarray(sel.kind),
                                  np.full(4, KIND_NONE))
