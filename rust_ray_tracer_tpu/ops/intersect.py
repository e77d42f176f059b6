"""Closest-hit intersection over structure-of-arrays primitives.

This replaces the reference's pointer-tree BVH recursion
(the reference's ``src/geometry/mod.rs:137-153``) with a dense wavefront
search:

**Triangles are linear in the ray's Plücker features.** The
Möller–Trumbore quantities are scalar triple products, and every one
needed is *linear* in ``f = [o, d, o×d, 1]``:

    det   = [e1, d, e2] = -d·n                    (n = e1×e2)
    u_num = [o-v0, d, e2] = (o×d)·e2 - d·(e2×v0)
    v_num = [d, o-v0, e1] = -(o×d)·e1 - d·(v0×e1)
    t_num = [e2, o-v0, e1] = o·n - v0·n

so testing C rays against T triangles is a ``[C,10] @ [10,4T]``
contraction followed by an elementwise mask + argmin — the wavefront
layout the reference's own dead code was reaching for (``ray.rs:45-76``,
flat ``bvh/mod.rs``), minus the pointer chase. On the GPU the same
coefficients feed a fused Pallas kernel (``ops/tri_search.py``) that
writes only the per-ray winners; elsewhere the contraction runs as XLA.

**Selection is detached, values are recomputed.** Phase 1 (under
``stop_gradient``) finds the winning primitive per ray; phase 2 gathers the
winner's parameters and recomputes (t, u, v, normal) elementwise and
differentiably. Reverse-mode AD therefore never stores [C,T] residuals, and
gradients flow only through the winning primitive — the correct
interior-point derivative for a closest-hit discontinuity.

Semantics match the reference exactly where it matters:
  * triangle: backface cull unless double_sided, det eps 1e-5, u∈[0,1],
    v∈[0,1-u), t inclusive (triangle.rs:38-69);
  * sphere: smaller root preferred, ``disc > 0`` strict, UV from the *normal*
    for the near root but from the world-space *point* for the far root — a
    reference quirk (sphere.rs:52-95) replicated;
  * quad (aarect lowered): both sides hittable, normal faces the ray
    (aarect.rs:38-67), interval-inclusive bounds;
  * constant medium: exponential free-flight inside a sphere boundary
    (constant_medium.rs:46-80), competing by t with everything else.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rust_ray_tracer_tpu.ops import linalg as la
from rust_ray_tracer_tpu.ops import tri_search

INF = jnp.float32(jnp.inf)
TRI_DET_EPS = 1e-5      # triangle.rs:42
T_MIN = 1e-4            # ray.rs:89

# kind tags for the cross-kind argmin
KIND_NONE, KIND_TRI, KIND_SPH, KIND_QUAD, KIND_MED = 0, 1, 2, 3, 4


class Hit(NamedTuple):
    hit: jnp.ndarray      # [C] bool
    t: jnp.ndarray        # [C] (INF on miss)
    p: jnp.ndarray        # [C,3]
    normal: jnp.ndarray   # [C,3]
    u: jnp.ndarray        # [C]
    v: jnp.ndarray        # [C]
    mat: jnp.ndarray      # [C] int32


# ---------------------------------------------------------------------------
# Phase 1 helpers: masked candidate t for each kind (selection only)
# ---------------------------------------------------------------------------

def _ray_features(o, d):
    """Plücker ray features [o, d, o×d, 1] — [C,10]."""
    m = jnp.cross(o, d)
    ones = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return jnp.concatenate([o, d, m, ones], axis=-1)


def _tri_coeffs(v0, e1, e2):
    """Four [10, T] coefficient matrices (det, u_num, v_num, t_num):
    each Möller–Trumbore quantity is linear in the ray features
    [o, d, o×d, 1] (module docstring).

    All four are pre-scaled by 1/|e1×e2| so the determinant column
    yields ``det = -d·n̂`` (≤ |d|) regardless of triangle size. The
    u/v/t RATIOS are unchanged (numerator and denominator share the
    scale), but the degeneracy test becomes scale-invariant:
    ``|det| > TRI_DET_EPS·|d|`` is a pure angle test. The reference's
    absolute ``det > 1e-5`` (triangle.rs:42) silently rejects EVERY
    triangle of a millimetre-scale mesh (MetalRoughSpheres edges are
    ~1e-5 units, dets ~1e-10) — an upstream latent bug it never hits
    because its importer cannot load that asset; see the quirk ledger
    (SURVEY.md §7 / PARITY.md). Zero-area pads keep det == 0 (the
    guard divisor is 1) and can never pass the test."""
    n = jnp.cross(e1, e2)
    nl = jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True))
    inv_n = 1.0 / jnp.where(nl > 0, nl, 1.0)
    n = n * inv_n
    z = jnp.zeros_like(v0)
    zs = jnp.zeros(v0.shape[:-1], v0.dtype)

    def col(o_c, d_c, m_c, one_c):
        # [10, T] from the per-triangle [T,3] blocks + [T] constant
        return jnp.concatenate(
            [o_c.T, d_c.T, m_c.T, one_c[None, :]], axis=0)

    det = col(z, -n, z, zs)
    u_num = col(z, -jnp.cross(e2, v0) * inv_n, e2 * inv_n, zs)
    v_num = col(z, -jnp.cross(v0, e1) * inv_n, -e1 * inv_n, zs)
    t_num = col(n, z, z, -jnp.sum(v0 * n, axis=-1))
    return det, u_num, v_num, t_num


def _tri_quants(o, d, v0, e1, e2):
    """Differentiable per-pair MT quantities. Broadcasts [..., 3] operands."""
    n = jnp.cross(e1, e2)
    det = -la.dot(d, n)
    m = jnp.cross(o, d)
    u_num = la.dot(m, e2) - la.dot(d, jnp.cross(e2, v0))
    v_num = -la.dot(m, e1) - la.dot(d, jnp.cross(v0, e1))
    t_num = la.dot(o, n) - la.dot(v0, n)
    return det, u_num, v_num, t_num, n


def _tri_valid(det, u, v, t, double, t_min, t_max, dn):
    """``dn`` = |d| per ray ([C,1]): with unit-normal-scaled coefficients
    (_tri_coeffs) the test ``|det| > EPS·|d|`` is scale-invariant
    (pure grazing-angle cutoff)."""
    eps = TRI_DET_EPS * dn
    side_ok = (det > eps) | ((det < -eps) & double)
    return (side_ok & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (v < 1.0 - u)
            & (t >= t_min) & (t <= t_max))


def _tri_search_xla(scene, coeffs, o, d, t_min, t_max):
    """[C] best (t, index) over triangles as plain XLA, materializing the
    four [C,T] Plücker products. Ties go to the lowest index."""
    det_c, u_c, v_c, t_c = coeffs
    # HIGHEST: an f32 contraction on the GPU may otherwise run in TF32,
    # whose 10-bit mantissa picks the wrong surface where two are close
    # in t
    dot = partial(lax.dot_general,
                  dimension_numbers=(((1,), (0,)), ((), ())),
                  precision=lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
    feats = _ray_features(o, d)
    det = dot(feats, det_c)
    u = la.safe_div(dot(feats, u_c), det)
    v = la.safe_div(dot(feats, v_c), det)
    t = la.safe_div(dot(feats, t_c), det)
    dn = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    valid = _tri_valid(det, u, v, t, scene.tri_double[None, :],
                       t_min[:, None], t_max[:, None], dn)
    tt = jnp.where(valid, t, INF)
    idx = jnp.argmin(tt, axis=1)
    return (jnp.take_along_axis(tt, idx[:, None], axis=1)[:, 0],
            idx.astype(jnp.int32))


def _tri_search_kernel(scene, coeffs, o, d, t_min, t_max):
    """The same contract through the fused GPU kernel (ops/tri_search)."""
    tris = tri_search.pack_tris(*coeffs, scene.tri_double)
    return tri_search.search(o, d, t_min, t_max, tris,
                             scene.tri_cluster_min, scene.tri_cluster_max)


def _tri_candidates(scene, o, d, t_min, t_max):
    """[C] best (t, index) over triangles.

    The GPU runs the fused kernel; every other platform runs the XLA
    form. The choice is made when the program is lowered for its
    platform, so a render placed on the CPU of a GPU host still takes
    the XLA form, and a kernel failure on the GPU raises rather than
    falling back.
    """
    coeffs = _tri_coeffs(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    return lax.platform_dependent(scene, coeffs, o, d, t_min, t_max,
                                  cuda=_tri_search_kernel,
                                  default=_tri_search_xla)


def _sphere_roots(o, d, time, c0, c1, st0, st1, r):
    """Both quadratic roots and the time-lerped center (sphere.rs:52-63,
    145-148). Returns (root1, root2, disc_ok, center). Broadcasting: ray
    dims [..., 1], sphere dims [..., S]."""
    frac = la.safe_div(time - st0, st1 - st0)
    c = c0 + frac[..., None] * (c1 - c0)
    oc = o - c
    a = la.length_sq(d)
    b = la.dot(oc, d)
    cc = la.length_sq(oc) - r * r
    disc = b * b - a * cc
    ok = disc > 0.0
    sq = la.safe_sqrt(disc)
    root1 = la.safe_div(-b - sq, a)
    root2 = la.safe_div(-b + sq, a)
    return root1, root2, ok, c


def _sph_candidates(scene, o, d, time, t_min, t_max):
    root1, root2, ok, _c = _sphere_roots(
        o[:, None, :], d[:, None, :], time[:, None],
        scene.sph_c0[None], scene.sph_c1[None],
        scene.sph_t0[None], scene.sph_t1[None], scene.sph_r[None])
    tmn, tmx = t_min[:, None], t_max[:, None]
    ok1 = ok & (root1 >= tmn) & (root1 <= tmx)
    ok2 = ok & (root2 >= tmn) & (root2 <= tmx)
    t = jnp.where(ok1, root1, jnp.where(ok2, root2, INF))
    idx = jnp.argmin(t, axis=1)
    return jnp.take_along_axis(t, idx[:, None], axis=1)[:, 0], idx


def _quad_quants(o, d, q, u_e, v_e):
    """Plane hit + parallelogram coordinates. Broadcastable."""
    n = jnp.cross(u_e, v_e)
    denom = la.dot(d, n)
    t = la.safe_div(la.dot(q - o, n), denom)
    p = o + t[..., None] * d
    w = p - q
    inv_n2 = la.safe_div(1.0, la.length_sq(n))
    alpha = la.dot(jnp.cross(w, v_e), n) * inv_n2
    beta = la.dot(jnp.cross(u_e, w), n) * inv_n2
    return t, alpha, beta, n, denom, p


def _quad_candidates(scene, o, d, t_min, t_max):
    t, alpha, beta, n, denom, _p = _quad_quants(
        o[:, None, :], d[:, None, :],
        scene.quad_q[None], scene.quad_u[None], scene.quad_v[None])
    valid = ((jnp.abs(denom) > 0.0)
             & (t >= t_min[:, None]) & (t <= t_max[:, None])
             & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    tt = jnp.where(valid, t, INF)
    idx = jnp.argmin(tt, axis=1)
    return jnp.take_along_axis(tt, idx[:, None], axis=1)[:, 0], idx


def _med_t(scene, o, d, med_u, t_min, t_max=None):
    """Per-(ray, medium) stochastic scatter distance — [C, M] t (INF=none).

    Mirrors constant_medium.rs:46-80: boundary hit over (-inf, inf) gives
    the entry/exit pair; clamp to [t_min, t_max]; exponential free flight.
    Boundaries are spheres (quadratic roots) or convex polytopes
    (half-space slab interval) per ``scene.med_kind``. The reference
    also clamps the exit by the running closest-so-far (its list scan
    shrinks t_max); here media compete in the cross-kind argmin instead,
    which discards exactly the same samples (a scatter beyond a closer
    surface never wins), so the winners are identical.
    """
    from rust_ray_tracer_tpu.models.scene import MED_POLY

    root1, root2, ok, _ = _sphere_roots(
        o[:, None, :], d[:, None, :],
        jnp.zeros(o.shape[0], o.dtype)[:, None],
        scene.med_c[None], scene.med_c[None],
        jnp.zeros_like(scene.med_r)[None], jnp.ones_like(scene.med_r)[None],
        scene.med_r[None])
    if scene.med_pl_n.shape[1]:
        # convex polytope: inside is the intersection of n·p <= d.
        # Along p(t) = o + t·d each half-space is a one-sided bound on
        # t: den = n·d > 0 bounds above (exit), den < 0 bounds below
        # (entry), den ~ 0 requires the origin side to be inside.
        # Pad planes (n=0, d=1) never constrain; sphere rows are all
        # padding and are masked out by med_kind below.
        n = scene.med_pl_n[None]                        # [1,M,P,3]
        doff = scene.med_pl_d[None]                     # [1,M,P]
        den = jnp.sum(n * d[:, None, None, :], -1)      # [C,M,P]
        num = doff - jnp.sum(n * o[:, None, None, :], -1)
        par = jnp.abs(den) < 1e-12
        par_ok = ~par | (num >= 0.0)
        to = num / jnp.where(par, 1.0, den)
        t_ent = jnp.where(~par & (den < 0), to, -jnp.inf)
        t_exi = jnp.where(~par & (den > 0), to, jnp.inf)
        t1_p = jnp.max(t_ent, axis=-1)                  # [C,M]
        t2_p = jnp.min(t_exi, axis=-1)
        ok_p = (jnp.all(par_ok, axis=-1) & (t1_p < t2_p)
                & jnp.isfinite(t2_p))
        is_poly = (scene.med_kind == MED_POLY)[None]
        root1 = jnp.where(is_poly, t1_p, root1)
        root2 = jnp.where(is_poly, t2_p, root2)
        ok = jnp.where(is_poly, ok_p, ok)
    if scene.med_tri.shape[1]:
        # triangle-mesh boundary: the reference's entry/exit pair is
        # two closest-hit queries over the same mesh — hit1 over
        # (-inf, inf), hit2 over (hit1.t + 1e-4, inf)
        # (constant_medium.rs:47-49) — with the triangle's own facing
        # rule (backface cull unless double-sided, triangle.rs). A
        # single-sided closed boundary therefore finds no exit and
        # yields no medium, exactly like the reference. Möller-Trumbore
        # with the main path's scale-invariant degeneracy cutoff
        # (|det|/|n| > 1e-5 |d|).
        from rust_ray_tracer_tpu.models.scene import MED_MESH
        mt = scene.med_tri                              # [M,Tm,10]
        v0 = mt[None, :, :, 0:3]                        # [1,M,Tm,3]
        e1 = mt[None, :, :, 3:6]
        e2 = mt[None, :, :, 6:9]
        dbl = mt[None, :, :, 9]
        o4 = o[:, None, None, :]                        # [C,1,1,3]
        d4 = d[:, None, None, :]
        n = jnp.cross(e1, e2)                           # [1,M,Tm,3]
        inv_n = 1.0 / jnp.maximum(la.length(n), 1e-30)  # [1,M,Tm]
        pv = jnp.cross(d4, e2)
        det = jnp.sum(e1 * pv, -1) * inv_n              # [C,M,Tm]
        eps = 1e-5 * la.length(d)[:, None, None]
        side_ok = (det > eps) | ((det < -eps) & (dbl > 0.5))
        inv = 1.0 / jnp.where(jnp.abs(det) > eps, det, 1.0)
        tv = o4 - v0
        u = jnp.sum(tv * pv, -1) * inv_n * inv
        qv = jnp.cross(tv, e1)
        v = jnp.sum(d4 * qv, -1) * inv_n * inv
        t = jnp.sum(e2 * qv, -1) * inv_n * inv
        valid = (side_ok & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (v < 1.0 - u))
        tt = jnp.where(valid, t, INF)                   # [C,M,Tm]
        t1_m = jnp.min(tt, axis=-1)                     # [C,M] hit1
        tt2 = jnp.where(tt > t1_m[..., None] + 1e-4, tt, INF)
        t2_m = jnp.min(tt2, axis=-1)                    # [C,M] hit2
        ok_m = (t1_m < INF) & (t2_m < INF)
        is_mesh = (scene.med_kind == MED_MESH)[None]
        root1 = jnp.where(is_mesh, t1_m, root1)
        root2 = jnp.where(is_mesh, t2_m, root2)
        ok = jnp.where(is_mesh, ok_m, ok)
    t1 = jnp.maximum(root1, t_min[:, None])
    # the t_max clamp (constant_medium.rs:55) only matters for collapsed
    # dead-lane windows (t_max <= t_min must reject EVERY kind — the
    # integrator's wavefront invariant); live search lanes pass inf here
    t2 = root2 if t_max is None else jnp.minimum(root2, t_max[:, None])
    ok = ok & (t1 < t2)
    t1 = jnp.maximum(t1, 0.0)
    ray_len = la.length(d)[:, None]
    dist_in = (t2 - t1) * ray_len
    # U in [0,1); ln(U) with U==0 guarded (thread_rng gen::<f32>() is [0,1))
    hit_dist = scene.med_neg_inv_d[None] * jnp.log(
        jnp.maximum(med_u, 1e-30))
    ok = ok & (hit_dist <= dist_in)
    t = t1 + la.safe_div(hit_dist, ray_len)
    return jnp.where(ok, t, INF)


# ---------------------------------------------------------------------------
# Phase 2: differentiable recompute for the per-kind winner
# ---------------------------------------------------------------------------

def _flip_normal(normal, flip):
    """FlipFace: normal.y = -|normal.y| (geometry/mod.rs:226-230)."""
    ny = jnp.where(flip, -jnp.abs(normal[..., 1]), normal[..., 1])
    return normal.at[..., 1].set(ny)


def _sphere_uv(p_unit):
    """Spherical UV from a point on the unit sphere (sphere.rs:34-40).

    Gradient-safe at the poles: arccos' is infinite at |x| = 1 and
    arctan2's gradient is NaN at (0, 0) — garbage lanes (miss/pad, whose
    UV cotangent is zero) saturate the clip EXACTLY and inf * 0 = NaN
    would poison every upstream gradient. The 1e-7 shrink is below f32
    UV resolution.
    """
    y = jnp.clip(-p_unit[..., 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(y)
    x = p_unit[..., 0]
    z = p_unit[..., 2]
    degen = (jnp.abs(x) < 1e-12) & (jnp.abs(z) < 1e-12)
    x = jnp.where(degen, 1e-12, x)
    phi = jnp.arctan2(-z, x) + jnp.pi
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def hit_attrs_core(o, d, time, t_min, t_max, kind, flip, pack, t_med):
    """Differentiable hit attributes from the detached selection.

    Pure function of the per-ray gathered winner pack (the gather — and
    therefore its scatter-add transpose — stays outside):
      pack  [C,9]: the winner's parameters, read per kind as
                   tri v0, e1, e2 / sphere c0, c1, t0, t1, r / quad q, u, v
                   (every kind's math is eps-guarded, so the other
                   readings stay finite and the kind-select discards them)
      t_med [C]  : differentiable medium scatter distance
      kind [C] int32 (KIND_*), flip [C] bool (selected primitive's flag)

    Returns (t, p, normal, u, v).
    """
    c = o.shape[0]

    # --- triangle (triangle.rs:38-69)
    v0, e1, e2 = pack[:, 0:3], pack[:, 3:6], pack[:, 6:9]
    det, u_num, v_num, t_num, n = _tri_quants(o, d, v0, e1, e2)
    inv_det = la.safe_div(1.0, det)
    t_tri = t_num * inv_det
    u_tri = u_num * inv_det
    v_tri = v_num * inv_det
    n_tri = la.normalize(n) * jnp.sign(det)[..., None]

    # --- sphere (sphere.rs:52-95, 145-148)
    root1, root2, ok, cen = _sphere_roots(
        o, d, time, pack[:, 0:3], pack[:, 3:6],
        pack[:, 6], pack[:, 7], pack[:, 8])
    ok1 = ok & (root1 >= t_min) & (root1 <= t_max)
    t_sph = jnp.where(ok1, root1, root2)
    p_sph = o + t_sph[..., None] * d
    # radius floor 1e-12 (not 1e-20): reverse-mode computes -1/r_floor^2,
    # and 1e-40 overflows f32 to inf -> inf * 0 = NaN for lanes whose
    # unified pack presents a zero "radius" (e.g. a quad winner whose
    # v.z == 0). Bitwise no-op for any real sphere radius.
    n_sph = (p_sph - cen) / jnp.maximum(pack[:, 8], 1e-12)[..., None]
    # UV quirk: near root uses the unit normal, far root world p
    # (sphere.rs:66-69 vs 80-82)
    uv_src = jnp.where(ok1[..., None], n_sph, p_sph)
    u_sph, v_sph = _sphere_uv(uv_src)

    # --- quad (aarect lowered)
    t_qud, a_qud, b_qud, nq, denom, p_qud = _quad_quants(
        o, d, pack[:, 0:3], pack[:, 3:6], pack[:, 6:9])
    nq_hat = la.normalize(nq)
    n_qud = nq_hat * -jnp.sign(la.dot(d, nq_hat))[..., None]

    # --- select by kind (miss lanes get t=0 HERE so p stays finite —
    # an inf t would put NaNs in untaken where-branches and poison
    # reverse-mode; the final t is patched to inf after p)
    zero = jnp.zeros((c,), o.dtype)
    t = jnp.where(kind == KIND_TRI, t_tri,
                  jnp.where(kind == KIND_SPH, t_sph,
                            jnp.where(kind == KIND_QUAD, t_qud,
                                      jnp.where(kind == KIND_MED, t_med,
                                                0.0))))
    p = o + t[..., None] * d
    n_med = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], o.dtype),
                             (c, 3))   # constant_medium.rs:72
    normal = jnp.where((kind == KIND_TRI)[:, None], n_tri,
                       jnp.where((kind == KIND_SPH)[:, None], n_sph,
                                 jnp.where((kind == KIND_QUAD)[:, None],
                                           n_qud, n_med)))
    uu = jnp.where(kind == KIND_TRI, u_tri,
                   jnp.where(kind == KIND_SPH, u_sph,
                             jnp.where(kind == KIND_QUAD, a_qud, zero)))
    vv = jnp.where(kind == KIND_TRI, v_tri,
                   jnp.where(kind == KIND_SPH, v_sph,
                             jnp.where(kind == KIND_QUAD, b_qud, zero)))
    normal = _flip_normal(normal, flip)
    t = jnp.where(kind == KIND_NONE, jnp.inf, t)
    return t, p, normal, uu, vv


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

class Select(NamedTuple):
    """Detached phase-1 winner + differentiable per-ray parameter packs:
    everything ``intersect`` needs before the phase-2 attribute math."""
    hit: jnp.ndarray        # [C] bool
    kind: jnp.ndarray       # [C] int32 (KIND_*, detached)
    idx: jnp.ndarray        # [C] int32 (detached)
    mat: jnp.ndarray        # [C] int32 material id of the winner
    flip: jnp.ndarray       # [C] bool
    pack: jnp.ndarray       # [C,9] the WINNER's differentiable params —
                            # unified across kinds (tri: v0,e1,e2 /
                            # sphere: c0,c1,t0,t1,r / quad: q,u,v); the
                            # consumer interprets by ``kind``
    t_med: jnp.ndarray      # [C] differentiable medium scatter t
    t_min: jnp.ndarray      # [C]
    t_max: jnp.ndarray      # [C]


# above this primitive count, phase 2 stops building the fused [P, 11]
# row table per bounce and gathers from the per-kind tables instead
# (the per-bounce table build grows with P, the gather does not); tests
# lower it to pin both branches to identical outputs
FUSED_ROW_MAX = 65536


def intersect_select(scene, o, d, time, med_u=None, t_min=None,
                     t_max=None) -> Select:
    """Phase 1 (detached candidate search) + winner parameter gathers."""
    c = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(T_MIN if t_min is None else t_min,
                                         o.dtype), (c,))
    t_max = jnp.broadcast_to(jnp.asarray(INF if t_max is None else t_max,
                                         o.dtype), (c,))

    # ---- phase 1: detached candidate search ----
    os, ds, ts = map(lax.stop_gradient, (o, d, time))
    scene_s = jax.tree.map(
        lambda x: lax.stop_gradient(x) if isinstance(x, jnp.ndarray) else x,
        scene)

    best_t = jnp.full((c,), INF)
    best_kind = jnp.zeros((c,), jnp.int32)
    best_idx = jnp.zeros((c,), jnp.int32)
    t_med_best = None

    def consider(kind, t_cand, idx):
        nonlocal best_t, best_kind, best_idx
        better = t_cand < best_t
        best_t = jnp.where(better, t_cand, best_t)
        best_kind = jnp.where(better, kind, best_kind)
        best_idx = jnp.where(better, idx, best_idx)

    if scene.n_tris:
        t_tri, i_tri = _tri_candidates(scene_s, os, ds, t_min, t_max)
        consider(KIND_TRI, t_tri, i_tri.astype(jnp.int32))
    if scene.n_spheres:
        t_sph, i_sph = _sph_candidates(scene_s, os, ds, ts, t_min, t_max)
        consider(KIND_SPH, t_sph, i_sph.astype(jnp.int32))
    if scene.n_quads:
        t_qud, i_qud = _quad_candidates(scene_s, os, ds, t_min, t_max)
        consider(KIND_QUAD, t_qud, i_qud.astype(jnp.int32))
    if scene.n_media:
        if med_u is None:
            raise ValueError("scene has media: med_u uniforms required")
        t_med = _med_t(scene_s, os, ds, lax.stop_gradient(med_u), t_min,
                       t_max)
        i_med = jnp.argmin(t_med, axis=1)
        t_med_b = jnp.take_along_axis(t_med, i_med[:, None], axis=1)[:, 0]
        consider(KIND_MED, t_med_b, i_med.astype(jnp.int32))
        # differentiable medium t for phase 2
        t_med_diff = _med_t(scene, o, d, med_u, t_min, t_max)
        t_med_best = jnp.take_along_axis(
            t_med_diff, i_med[:, None], axis=1)[:, 0]

    hit_mask = jnp.isfinite(best_t)
    best_kind = jnp.where(hit_mask, best_kind, KIND_NONE)

    # Tag the (detached, [C]-sized) selection as named rematerialization
    # residuals: under jax.checkpoint(policy=save_only_these_names(
    # 'isect_sel')) the backward pass re-runs only the cheap phase-2
    # recompute and NEVER the candidate search. Saving these changes no
    # values — phase 1 is deterministic and detached.
    from jax.ad_checkpoint import checkpoint_name
    best_kind = checkpoint_name(best_kind, "isect_sel")
    best_idx = checkpoint_name(best_idx, "isect_sel")
    hit_mask = checkpoint_name(hit_mask, "isect_sel")

    # ---- phase 2: differentiable recompute of the winner ----
    # ONE wide f32 row gather for every primitive kind: the per-kind
    # tables (pack(9) | flip | mat-id) are concatenated into one
    # [sum P_k, 11] table and the winner row is fetched by
    # offset[kind] + idx (one gather forward, one scatter-add backward).
    # The 9-float pack is interpreted per kind downstream (every
    # sub-computation is eps-guarded, so non-winner interpretations are
    # finite garbage the kind-select discards in both directions).
    # flip / mat-id are exact small integers in f32.
    f32 = o.dtype
    ext = jnp.zeros((c, 2), f32)             # flip | mat id

    def kind_table(pack_cols, flip_col, mat_col):
        return jnp.concatenate(
            [pack_cols, flip_col.astype(f32)[:, None],
             mat_col.astype(f32)[:, None]], axis=1)

    kind_cols = []
    if scene.n_tris:
        kind_cols.append((KIND_TRI, jnp.concatenate(
            [scene.tri_v0, scene.tri_e1, scene.tri_e2], axis=1),
            scene.tri_flip, scene.tri_mat))
    if scene.n_spheres:
        kind_cols.append((KIND_SPH, jnp.concatenate(
            [scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
             scene.sph_t1[:, None], scene.sph_r[:, None]], axis=1),
            scene.sph_flip, scene.sph_mat))
    if scene.n_quads:
        kind_cols.append((KIND_QUAD, jnp.concatenate(
            [scene.quad_q, scene.quad_u, scene.quad_v], axis=1),
            scene.quad_flip, scene.quad_mat))

    # miss/none/medium lanes default to the FIRST kind's row 0 (what the
    # unified gather's clamped index 0 yields) — finite, and both
    # branches below agree bitwise
    if kind_cols:
        pack = jnp.broadcast_to(
            jnp.asarray(kind_cols[0][1][0], f32)[None], (c, 9))
    else:
        pack = jnp.zeros((c, 9), f32)

    total_rows = sum(kc[1].shape[0] for kc in kind_cols)
    if kind_cols and total_rows <= FUSED_ROW_MAX:
        uni = jnp.concatenate(
            [kind_table(pc, fc, mc) for _, pc, fc, mc in kind_cols],
            axis=0)
        idx_u = jnp.zeros((c,), jnp.int32)
        off = 0
        for kd, pc, _, _ in kind_cols:
            idx_u = jnp.where(best_kind == kd, best_idx + off, idx_u)
            off += pc.shape[0]
        rows = uni[idx_u]
        pack = rows[:, :9]
        prim = jnp.zeros((c,), bool)
        for kd, _, _, _ in kind_cols:
            prim = prim | (best_kind == kd)
        ext = jnp.where(prim[:, None], rows[:, 9:], ext)
    else:
        for kd, pc, fc, mc in kind_cols:
            sel_k = best_kind == kd
            idx = jnp.where(sel_k, best_idx, 0)
            rows_k = kind_table(pc, fc, mc)[idx]
            pack = jnp.where(sel_k[:, None], rows_k[:, :9], pack)
            ext = jnp.where(sel_k[:, None], rows_k[:, 9:], ext)
    if scene.n_media:
        i_m = jnp.where(best_kind == KIND_MED, best_idx, 0)
        med_row = jnp.stack(
            [jnp.zeros((scene.n_media,), f32),
             scene.med_mat.astype(f32)], axis=1)[i_m]
        ext = jnp.where((best_kind == KIND_MED)[:, None], med_row, ext)
    if t_med_best is None:
        t_med_best = jnp.zeros((c,), o.dtype)

    flip = ext[:, 0] > 0.5
    mat = ext[:, 1].astype(jnp.int32)

    # named so a remat policy can choose to save the gathered packs
    # (the integrator's default SAVE_NAMES does not)
    pack = checkpoint_name(pack, "isect_packs")
    t_med_best = checkpoint_name(t_med_best, "isect_packs")

    return Select(hit=hit_mask, kind=best_kind, idx=best_idx, mat=mat,
                  flip=flip, pack=pack, t_med=t_med_best,
                  t_min=t_min, t_max=t_max)


def intersect(scene, o, d, time, med_u=None, t_min=None, t_max=None) -> Hit:
    """Closest hit for a chunk of rays.

    Args:
      scene: SceneData.
      o, d: [C,3] ray origins / (unnormalized) directions.
      time: [C] ray times.
      med_u: [C, M] uniforms for constant-medium free-flight sampling
        (required iff the scene has media).
      t_min, t_max: [C] or scalars; defaults 1e-4 / inf (ray.rs:89).

    Returns a :class:`Hit`. The winning-primitive choice is detached; the
    returned (t, p, normal, u, v) are differentiable w.r.t. scene and ray.
    """
    from jax.ad_checkpoint import checkpoint_name

    sel = intersect_select(scene, o, d, time, med_u, t_min, t_max)
    t, p, normal, uu, vv = hit_attrs_core(
        o, d, time, sel.t_min, sel.t_max, sel.kind, sel.flip, sel.pack,
        sel.t_med)
    t = checkpoint_name(t, "hit_attrs")
    p = checkpoint_name(p, "hit_attrs")
    normal = checkpoint_name(normal, "hit_attrs")
    uu = checkpoint_name(uu, "hit_attrs")
    vv = checkpoint_name(vv, "hit_attrs")

    return Hit(hit=sel.hit, t=t, p=p, normal=normal, u=uu, v=vv,
               mat=sel.mat)
