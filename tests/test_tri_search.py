"""Closest-hit triangle search against a NumPy Möller–Trumbore.

Both forms of the search are checked case by case: the XLA form every
platform but the GPU runs (``intersect._tri_search_xla``) and the GPU's
Pallas kernel in interpret mode (``ops/tri_search.search``). The NumPy
reference tests every (ray, triangle) pair in float64 with the same
semantics (scale-invariant grazing cutoff, backface cull unless
double-sided, u in [0,1], v in [0, 1-u), t in [t_min, t_max], lowest
index on equal t).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rust_ray_tracer_tpu.models import builders
from rust_ray_tracer_tpu.models import scene as S
from rust_ray_tracer_tpu.models.scene import CLUSTER, compile_scene
from rust_ray_tracer_tpu.ops import intersect as it
from rust_ray_tracer_tpu.ops import tri_search
from rust_ray_tracer_tpu.ops.camera import make_camera

MAT = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
SEARCHES = ["xla", "kernel"]


def numpy_mt(sd, o, d, t_min, t_max):
    """[C] (best t, best index) over the compiled triangle table."""
    v0 = np.asarray(sd.tri_v0, np.float64)
    e1 = np.asarray(sd.tri_e1, np.float64)
    e2 = np.asarray(sd.tri_e2, np.float64)
    dbl = np.asarray(sd.tri_double)
    o = np.asarray(o, np.float64)[:, None]
    d = np.asarray(d, np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    nl = np.linalg.norm(np.cross(e1, e2), axis=-1)[None]
    eps = 1e-5 * np.linalg.norm(d, axis=-1) * nl
    side = (det > eps) | ((det < -eps) & dbl[None])
    safe = np.where(np.abs(det) > 0, det, 1.0)
    tv = o - v0[None]
    u = (tv * p).sum(-1) / safe
    q = np.cross(tv, e1[None])
    v = (d * q).sum(-1) / safe
    t = (e2[None] * q).sum(-1) / safe
    ok = (side & (nl > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v < 1 - u)
          & (t >= np.asarray(t_min)[:, None])
          & (t <= np.asarray(t_max)[:, None]))
    tt = np.where(ok, t, np.inf)
    idx = np.argmin(tt, axis=1)
    return tt[np.arange(len(idx)), idx], idx


def run_search(search, sd, o, d, t_min, t_max):
    coeffs = it._tri_coeffs(sd.tri_v0, sd.tri_e1, sd.tri_e2)
    if search == "xla":
        t, i = it._tri_search_xla(sd, coeffs, o, d, t_min, t_max)
    else:
        tris = tri_search.pack_tris(*coeffs, sd.tri_double)
        t, i = tri_search.search(o, d, t_min, t_max, tris,
                                 sd.tri_cluster_min, sd.tri_cluster_max,
                                 interpret=True)
    return np.asarray(t), np.asarray(i)


def check(search, sd, o, d, t_min=None, t_max=None, min_hits=1):
    c = o.shape[0]
    t_min = jnp.full(c, 1e-4) if t_min is None else t_min
    t_max = jnp.full(c, jnp.inf) if t_max is None else t_max
    t, i = run_search(search, sd, o, d, t_min, t_max)
    rt, ri = numpy_mt(sd, o, d, t_min, t_max)
    hit = np.isfinite(rt)
    assert hit.sum() >= min_hits, "setup: rays must hit something"
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5)
    # same winner except at genuine near-ties
    diff = hit & (i != ri)
    assert (np.abs(t[diff] - rt[diff]) <= 1e-5 * np.abs(rt[diff])).all()
    assert diff.mean() <= 1e-3 + 1.0 / c
    return t, i


def soup(n, seed=0, spread=3.0, size=0.6, double=True):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        v0 = rng.uniform(-spread, spread, 3).astype(np.float32)
        v0[2] -= 6.0
        e = rng.uniform(-size, size, (2, 3)).astype(np.float32)
        tris.append(S.Triangle(v0, v0 + e[0], v0 + e[1], MAT,
                               double_sided=double))
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return compile_scene(S.Scene(cam, tris, [], (0, 0, 0)))


def rays(n, seed=1, toward=(0.0, 0.0, -6.0)):
    """Rays from around the origin toward the soup, plus a scatter of
    random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3))
    tgt = np.asarray(toward) + rng.uniform(-3, 3, (n, 3))
    d = tgt - o
    d[::4] = rng.standard_normal((len(d[::4]), 3))
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("n_tris,n_rays",
                         [(1, 63), (CLUSTER, 64), (300, 257), (1000, 300)])
def test_matches_numpy(search, n_tris, n_rays):
    sd = soup(n_tris, seed=n_tris, spread=3.0 if n_tris > 1 else 0.3,
              size=0.6 if n_tris > 1 else 4.0)
    o, d = rays(n_rays, seed=n_rays)
    check(search, sd, o, d)


@pytest.mark.parametrize("search", SEARCHES)
def test_dead_rays_hit_nothing(search):
    sd = soup(200)
    o, d = rays(96)
    live_t, _ = check(search, sd, o, d)
    dead = jnp.arange(96) % 3 == 0
    t_max = jnp.where(dead, -1.0, jnp.inf)
    t, _ = run_search(search, sd, o, d, jnp.full(96, 1e-4), t_max)
    assert not np.isfinite(t[np.asarray(dead)]).any()
    np.testing.assert_array_equal(t[~np.asarray(dead)],
                                  live_t[~np.asarray(dead)])


@pytest.mark.parametrize("search", SEARCHES)
def test_ties_lowest_index_wins(search):
    """The same triangle twice (and a third copy in another cluster):
    equal t everywhere, so the lowest compiled index must win."""
    tri = ((-1, -1, -4), (1, -1, -4), (0, 1, -4))
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    far = [S.Triangle((x, 9, -9), (x + 0.1, 9, -9), (x, 9.1, -9), MAT)
           for x in np.linspace(-5, 5, 2 * CLUSTER)]
    sd = compile_scene(S.Scene(
        cam, [S.Triangle(*tri, MAT, double_sided=True)] * 3 + far, [],
        (0, 0, 0)))
    o = jnp.zeros((16, 3), jnp.float32)
    d = jnp.asarray(np.c_[np.linspace(-0.1, 0.1, 16), np.zeros(16),
                          -np.ones(16)], jnp.float32)
    t, i = run_search(search, sd, o, d, jnp.full(16, 1e-4),
                      jnp.full(16, jnp.inf))
    v0 = np.asarray(sd.tri_v0)
    copies = np.nonzero((np.abs(v0 - np.asarray(tri[0])) < 1e-6).all(1))[0]
    assert len(copies) == 3
    assert np.isfinite(t).all()
    assert (i == copies.min()).all()


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("double", [True, False])
def test_backface_cull_unless_double_sided(search, double):
    cam = make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    # counter-clockwise seen from +z: front face toward the camera
    sd = compile_scene(S.Scene(cam, [S.Triangle(
        (-1, -1, -4), (1, -1, -4), (0, 1, -4), MAT, double_sided=double)],
        [], (0, 0, 0)))
    o = jnp.asarray([[0, 0, 0], [0, 0, -8]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, 1]], jnp.float32)
    t, _ = run_search(search, sd, o, d, jnp.full(2, 1e-4),
                      jnp.full(2, jnp.inf))
    rt, _ = numpy_mt(sd, o, d, np.full(2, 1e-4), np.full(2, np.inf))
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(rt))
    assert np.isfinite(t).sum() == (2 if double else 1)


@pytest.mark.parametrize("search", SEARCHES)
def test_multi_cluster_mesh(search):
    """The flagship generator at 700 triangles: 6 Morton clusters, rays
    from the camera through the frame and from inside the mesh box."""
    sd = compile_scene(builders.flagship(16 / 9, 0, 700))
    assert sd.tri_cluster_min.shape[0] == 6
    rng = np.random.default_rng(3)
    o = np.r_[np.zeros((64, 3)), rng.uniform(-1, 1, (64, 3))
              + [0, 0, -4.0]]
    d = np.r_[np.c_[rng.uniform(-0.3, 0.3, (64, 2)), -np.ones(64)],
              rng.standard_normal((64, 3))]
    check(search, sd, jnp.asarray(o, jnp.float32),
          jnp.asarray(d, jnp.float32), min_hits=20)


@pytest.mark.parametrize("search", SEARCHES)
def test_padding_never_hits(search):
    """130 triangles pad to 256: the 126 zero-edge pad triangles sit at
    the origin and must never win, not even for rays through it."""
    sd = soup(130, spread=1.0)
    assert sd.n_tris == 256
    o = jnp.asarray(np.r_[np.full((8, 3), -1.0), np.zeros((8, 3))],
                    jnp.float32)
    d = jnp.asarray(np.r_[np.ones((8, 3)), np.eye(3)[[0, 1, 2] * 2 + [0, 2]]],
                    jnp.float32)
    t, i = run_search(search, sd, o, d, jnp.full(16, -1.0),
                      jnp.full(16, jnp.inf))
    hit = np.isfinite(t)
    assert (i[hit] < 130).all()
    rt, _ = numpy_mt(sd, o, d, np.full(16, -1.0), np.full(16, np.inf))
    np.testing.assert_array_equal(hit, np.isfinite(rt))


def test_pack_tris_rows_are_the_plucker_coefficients():
    """The kernel's packed table evaluates to the same det/u/v/t
    numerators as the [10, T] coefficient matrices."""
    sd = soup(40)
    coeffs = it._tri_coeffs(sd.tri_v0, sd.tri_e1, sd.tri_e2)
    tab = np.asarray(tri_search.pack_tris(*coeffs, sd.tri_double))
    assert tab.shape == (tri_search.N_ROWS, sd.n_tris)
    o, d = rays(5)
    f = np.asarray(it._ray_features(o, d))
    o, d = np.asarray(o), np.asarray(d)
    m = np.cross(o, d)
    det = d @ tab[0:3]
    u = d @ tab[3:6] + m @ tab[6:9]
    v = d @ tab[9:12] + m @ tab[12:15]
    t = o @ tab[15:18] + tab[18]
    for got, c in zip((det, u, v, t), coeffs):
        np.testing.assert_allclose(got, f @ np.asarray(c), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tab[19], np.asarray(sd.tri_double))


def test_kernel_pads_ragged_ray_counts():
    """C not a multiple of BLOCK_RAYS: outputs keep the caller's C."""
    sd = soup(128)
    for c in (1, tri_search.BLOCK_RAYS - 1, tri_search.BLOCK_RAYS + 3):
        o, d = rays(c, seed=c)
        t, i = run_search("kernel", sd, o, d, jnp.full(c, 1e-4),
                          jnp.full(c, jnp.inf))
        assert t.shape == (c,) and i.shape == (c,) and i.dtype == np.int32


def test_kernel_rejects_ragged_clusters():
    sd = soup(128)
    coeffs = it._tri_coeffs(sd.tri_v0, sd.tri_e1, sd.tri_e2)
    tris = tri_search.pack_tris(*coeffs, sd.tri_double)[:, :100]
    o, d = rays(4)
    with pytest.raises(ValueError):
        tri_search.search(o, d, jnp.zeros(4), jnp.full(4, jnp.inf), tris,
                          sd.tri_cluster_min, sd.tri_cluster_max,
                          interpret=True)


def test_platform_choice_at_lowering():
    """The GPU lowering of a render carries the Triton kernel; the CPU
    lowering of the same program does not (the search is chosen per
    platform when the program is lowered)."""
    from rust_ray_tracer_tpu.ops.integrator import render_waves

    sd = soup(200)
    fn = jax.jit(lambda s, k: render_waves(s, 16, 8, k, 0, 1,
                                           chunk_size=128))
    traced = fn.trace(sd, jax.random.PRNGKey(0))
    assert "triton" not in traced.lower(
        lowering_platforms=("cpu",)).as_text()
    assert "__gpu$xla.gpu.triton" in traced.lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_xla(gpu):
    """On the card: the compiled kernel (not the interpreter) against the
    XLA form at the flagship's width."""
    sd = compile_scene(builders.flagship(16 / 9))
    o, d = rays(9216)
    t_min = jnp.full(9216, 1e-4)
    t_max = jnp.full(9216, jnp.inf)
    coeffs = it._tri_coeffs(sd.tri_v0, sd.tri_e1, sd.tri_e2)
    tx, ix = it._tri_search_xla(sd, coeffs, o, d, t_min, t_max)
    tk, ik = tri_search.search(o, d, t_min, t_max,
                               tri_search.pack_tris(*coeffs, sd.tri_double),
                               sd.tri_cluster_min, sd.tri_cluster_max)
    assert (np.asarray(ix) == np.asarray(ik)).mean() >= 0.999
