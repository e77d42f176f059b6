"""Wavefront path-tracing integrator.

This is the data-parallel replacement for the reference's per-pixel recursion
(``ray_color``, ``/root/reference/src/ray.rs:78-127``) and its rayon
row-parallel render loop (``main.rs:86-112``): all rays of a sample-wave
advance together through a fixed number of bounces (MAX_DEPTH=4 in the
reference, ``main.rs:56``), carrying ``(radiance L, throughput beta, alive)``.

Estimator equivalence with the recursion:
  * hit + emission:   L += beta * emitted            (ray.rs:90,114)
  * diffuse scatter:  beta *= albedo * s_pdf / pdf   (ray.rs:114-120)
  * specular scatter: beta *= attenuation            (ray.rs:93-98)
  * no scatter:       ray dies after emission        (ray.rs:121-122)
  * miss:             L += beta * background, dies   (ray.rs:126)
  * depth exhausted:  remaining contribution is 0    (ray.rs:85-87)

Rays are processed in fixed-size chunks (``lax.map``) so the [chunk, P]
intersection intermediates stay bounded regardless of image size; each
bounce can be rematerialized (``jax.checkpoint``) so reverse-mode memory is
one bounce, not depth bounces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rust_ray_tracer_tpu.ops import camera as cam_ops
from rust_ray_tracer_tpu.ops.intersect import intersect
from rust_ray_tracer_tpu.ops.shade import shade
from rust_ray_tracer_tpu.utils import rng as rngu

MAX_DEPTH = 4  # main.rs:56

# Remat residuals saved per bounce (checkpoint names; see
# ops/intersect.py and ops/shade.py for where each is tagged). Saving a
# residual trades a forward write to device memory (which XLA might
# otherwise have fused away) against backward recompute, so the choice
# is per workload: triangle scenes also save the hit attributes and the
# albedo, sphere/quad-only scenes save just the selection. The choice
# has not been measured on the GPU yet.
SAVE_NAMES = ("isect_sel", "hit_attrs", "albedo")
SAVE_NAMES_NO_TRI = ("isect_sel",)


def _save_names(scene):
    return SAVE_NAMES if scene.n_tris else SAVE_NAMES_NO_TRI


def _bounce(scene, carry, bkey, rand=None):
    """One wavefront bounce: intersect + shade + state update.

    The whole bounce is guarded by ``lax.cond(any(alive))``: a chunk whose
    lanes have ALL terminated skips intersection, shading and RNG for the
    remaining bounces entirely (every state update is alive-masked, so
    the identity branch is exact). Within a live chunk, dead lanes are
    still evaluated (and masked).

    ``rand`` optionally supplies the bounce's whole random budget
    ``(ub [C,9], gb [C,6], med_u [C,M])`` pre-gathered per ray (the
    compacting wavefront, :func:`trace_wave_compact`); drawn from
    ``bkey`` when None — identical threefry streams either way.
    """

    def run(carry):
        o, d, time, L, beta, alive = carry
        c = o.shape[0]
        med_u = None
        if rand is not None:
            med_u = rand[2] if scene.n_media else None
        elif scene.n_media:
            med_u = jax.random.uniform(rngu.stream(bkey, rngu.MEDIUM),
                                       (c, scene.n_media), dtype=o.dtype)
        # dead lanes get a collapsed t-window: they can't hit anything,
        # and the GPU triangle search skips whole clusters that no live
        # ray of a block can enter (ops/tri_search.py)
        t_max = jnp.where(alive, jnp.inf, -1.0)
        hit = intersect(scene, o, d, time, med_u, t_max=t_max)

        miss = alive & ~hit.hit
        L = L + jnp.where(miss[:, None], beta * scene.background, 0.0)

        live = alive & hit.hit
        sc = shade(scene, bkey, d, time, hit, rand=rand and rand[:2])
        L = L + jnp.where(live[:, None], beta * sc.emitted, 0.0)
        beta = jnp.where(live[:, None], beta * sc.weight, beta)
        alive2 = live & sc.alive
        o = jnp.where(alive2[:, None], hit.p, o)
        d = jnp.where(alive2[:, None], sc.direction, d)
        return o, d, time, L, beta, alive2

    return lax.cond(jnp.any(carry[5]), run, lambda c: c, carry)


def auto_compact(scene, threshold: float = 0.3) -> bool:
    """Host-side heuristic: should a render of ``scene`` default to the
    cross-chunk alive compaction (:func:`trace_wave_compact`)?

    Compaction pays when most lanes STAY alive bounce over bounce
    (occupancy-bound scenes: the sorted live rays fill few chunks and the
    rest skip) and costs when most die at bounce 0 (the permutation
    gathers then buy nothing). The 0.3 threshold predates the GPU port;
    PERF.md records compact on/off times on the GPU beside it.

    Occupancy is a runtime quantity; its dominant driver is the primary
    hit fraction (a hit scatters and usually survives, a miss adds the
    background and dies). That fraction is estimated with a tiny
    host-side numpy probe: a 32x18 grid of pixel-center primaries
    (camera.rs:56-69 mapping) any-hit tested against spheres, quads,
    medium boundaries, and triangles — exact Möller–Trumbore up to 64k
    tris, conservative per-cluster AABB slabs beyond (dense huge meshes
    fill their cluster boxes, so the overestimate is small exactly where
    it is used).

    Must be called OUTSIDE jit (reads concrete values); callers resolve
    it once and pass a plain bool down (utils/cli.py ``--compact auto``).
    """
    import numpy as np

    cam = scene.camera
    c2w = np.asarray(cam.c2w, np.float64)          # [3,4] (R|t)
    scale = float(cam.scale)
    aspect = float(cam.aspect)
    eye = c2w[:, 3]
    gw, gh = 32, 18
    fx = (2.0 * (np.arange(gw) + 0.5) / gw - 1.0) * scale * aspect
    fy = (2.0 * (np.arange(gh) + 0.5) / gh - 1.0) * scale
    px, py = np.meshgrid(fx, fy)
    pc = np.stack([px.ravel(), py.ravel(), -np.ones(gw * gh)], 1)
    d = pc @ c2w[:, :3].T                          # unnormalized dirs
    o = np.broadcast_to(eye, d.shape)
    hit = np.zeros(d.shape[0], bool)
    tmin = 1e-4

    def sphere_hit(c, r):
        oc = o - c
        a = (d * d).sum(1)
        b = (oc * d).sum(1)
        cc = (oc * oc).sum(1) - r * r
        disc = b * b - a * cc
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
        return ok & ((t1 >= tmin) | (t2 >= tmin))

    if scene.n_spheres:
        c0 = np.asarray(scene.sph_c0, np.float64)
        r = np.asarray(scene.sph_r, np.float64)
        for i in np.nonzero(r > 0)[0]:
            hit |= sphere_hit(c0[i], r[i])
    if scene.n_media:
        mc = np.asarray(scene.med_c, np.float64)
        mr = np.asarray(scene.med_r, np.float64)
        kinds = np.asarray(scene.med_kind)
        from rust_ray_tracer_tpu.models.scene import (MED_MESH, MED_POLY,
                                                      MED_SPHERE)
        for i in np.nonzero((kinds == MED_SPHERE) & (mr > 0))[0]:
            hit |= sphere_hit(mc[i], mr[i])
        if scene.med_pl_n.shape[1]:
            # convex-polytope boundaries: the same half-space interval
            # test as _med_t, so a cuboid fog volume covering the frame
            # counts toward occupancy
            pn = np.asarray(scene.med_pl_n, np.float64)    # [M,P,3]
            pd = np.asarray(scene.med_pl_d, np.float64)    # [M,P]
            for i in np.nonzero(kinds == MED_POLY)[0]:
                den = d @ pn[i].T                          # [R,P]
                num = pd[i][None] - o @ pn[i].T
                par = np.abs(den) < 1e-12
                par_ok = (~par | (num >= 0)).all(1)
                to = num / np.where(par, 1.0, den)
                t1 = np.where(~par & (den < 0), to, -np.inf).max(1)
                t2 = np.where(~par & (den > 0), to, np.inf).min(1)
                hit |= par_ok & (t1 < t2) & np.isfinite(t2) & (t2 >= tmin)
        if scene.med_tri.shape[1]:
            # triangle-mesh boundaries: conservative AABB slab over the
            # real (non-pad) triangles, mirroring the big-mesh branch
            for i in np.nonzero(kinds == MED_MESH)[0]:
                mt = np.asarray(scene.med_tri[i], np.float64)  # [Tm,10]
                real = (np.abs(mt[:, 3:6]).sum(1)
                        + np.abs(mt[:, 6:9]).sum(1)) > 0
                if not real.any():
                    continue
                corners = np.stack(
                    [mt[real, 0:3], mt[real, 0:3] + mt[real, 3:6],
                     mt[real, 0:3] + mt[real, 6:9]], 1)
                lo = corners.reshape(-1, 3).min(0)
                hi = corners.reshape(-1, 3).max(0)
                inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
                t0 = (lo[None] - o) * inv                  # [R,3]
                t1 = (hi[None] - o) * inv
                tn = np.minimum(t0, t1).max(1)
                tf = np.maximum(t0, t1).min(1)
                hit |= (tf >= np.maximum(tn, tmin)) & (tf >= tmin)
    if scene.n_quads:
        q = np.asarray(scene.quad_q, np.float64)
        u = np.asarray(scene.quad_u, np.float64)
        v = np.asarray(scene.quad_v, np.float64)
        n = np.cross(u, v)                         # [Q,3]
        denom = d @ n.T                            # [R,Q]
        dsafe = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = ((q[None] - o[:, None]) * n[None]).sum(2) / dsafe
        w = o[:, None] + t[..., None] * d[:, None] - q[None]
        n2 = np.maximum((n * n).sum(1), 1e-12)
        alpha = (np.cross(w, v[None]) * n[None]).sum(2) / n2
        beta = (np.cross(u[None], w) * n[None]).sum(2) / n2
        ok = ((np.abs(denom) > 1e-12) & (t >= tmin)
              & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
        hit |= ok.any(1)
    if scene.n_tris:
        v0 = np.asarray(scene.tri_v0, np.float64)
        if scene.n_tris <= 65536:
            e1 = np.asarray(scene.tri_e1, np.float64)
            e2 = np.asarray(scene.tri_e2, np.float64)
            real = (np.abs(e1).sum(1) + np.abs(e2).sum(1)) > 0
            v0, e1, e2 = v0[real], e1[real], e2[real]
            for s in range(0, v0.shape[0], 4096):
                vv, ee1, ee2 = v0[s:s + 4096], e1[s:s + 4096], e2[s:s + 4096]
                p = np.cross(d[:, None], ee2[None])         # [R,B,3]
                det = (ee1[None] * p).sum(2)
                inv = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
                tv = o[:, None] - vv[None]
                uu = (tv * p).sum(2) * inv
                qv = np.cross(tv, ee1[None])
                vv_ = (d[:, None] * qv).sum(2) * inv
                tt = (ee2[None] * qv).sum(2) * inv
                ok = ((np.abs(det) > 1e-12) & (uu >= 0) & (uu <= 1)
                      & (vv_ >= 0) & (uu + vv_ <= 1) & (tt >= tmin))
                hit |= ok.any(1)
        else:
            lo = np.asarray(scene.tri_cluster_min, np.float64)
            hi = np.asarray(scene.tri_cluster_max, np.float64)
            ok = (lo <= hi).all(1)
            lo, hi = lo[ok], hi[ok]
            inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
            t0 = (lo[None] - o[:, None]) * inv[:, None]     # [R,K,3]
            t1 = (hi[None] - o[:, None]) * inv[:, None]
            tn = np.minimum(t0, t1).max(2)
            tf = np.maximum(t0, t1).min(2)
            hit |= ((tf >= np.maximum(tn, tmin)) & (tf >= tmin)).any(1)
    return float(hit.mean()) >= threshold


def trace_rays(scene, o, d, time, key, depth: int = MAX_DEPTH,
               remat: bool = True):
    """Trace a chunk of rays to completion. Returns radiance [C,3].

    Bounces run under ``lax.scan`` so the compiled program contains ONE
    bounce body regardless of depth — with a Python loop the backward
    pass inlines depth fwd+bwd copies and compile time grows with depth.
    ``jax.checkpoint`` on the body keeps reverse-mode memory at one
    bounce.
    """
    c = o.shape[0]
    L = jnp.zeros((c, 3), o.dtype)
    beta = jnp.ones((c, 3), o.dtype)
    alive = jnp.ones((c,), bool)
    keys = jax.vmap(partial(rngu.bounce_key, key))(jnp.arange(depth))
    if remat:
        # named per-bounce residuals (all [C]-sized): see SAVE_NAMES.
        # The candidate search is skipped via "isect_sel"
        # (ops/intersect.py).
        policy = jax.checkpoint_policies.save_only_these_names(
            *_save_names(scene))
        step = jax.checkpoint(partial(_bounce, scene), policy=policy)
    else:
        step = partial(_bounce, scene)

    def body(carry, bkey):
        return step(carry, bkey), None

    carry, _ = lax.scan(body, (o, d, time, L, beta, alive), keys)
    return carry[3]


def _wave_bounce_randoms(scene, wkey, chunk_ids, chunk_size: int, b,
                         dtype=jnp.float32):
    """Bounce-``b`` random budget for every lane of chunks ``chunk_ids``,
    chunk-major.

    Reproduces exactly the threefry streams the per-chunk path draws
    (camera ckey -> CHUNK stream -> bounce key -> SCATTER/FUZZ/MEDIUM),
    so the compacting wavefront can gather a ray's randomness from its
    ORIGINAL (chunk, lane) coordinate no matter which compacted chunk
    processes it — renders stay invariant to the compaction.
    """
    def one(cid):
        ck = jax.random.fold_in(wkey, cid)
        bk = rngu.bounce_key(rngu.stream(ck, rngu.CHUNK), b)
        ub = jax.random.uniform(rngu.stream(bk, rngu.SCATTER),
                                (chunk_size, 9), dtype=dtype)
        gb = jax.random.normal(rngu.stream(bk, rngu.FUZZ),
                               (chunk_size, 6), dtype=dtype)
        mu = (jax.random.uniform(rngu.stream(bk, rngu.MEDIUM),
                                 (chunk_size, scene.n_media),
                                 dtype=dtype)
              if scene.n_media else jnp.zeros((chunk_size, 0), dtype))
        return ub, gb, mu

    ub, gb, mu = jax.vmap(one)(chunk_ids)
    n = chunk_ids.shape[0] * chunk_size
    return ub.reshape(n, 9), gb.reshape(n, 6), mu.reshape(n, -1)


def trace_wave_compact(scene, wkey, width: int, height: int,
                       depth: int = MAX_DEPTH, chunk_size: int = 32768,
                       remat: bool = True, chunk_ids=None,
                       proc_chunk: int | None = None):
    """One sample-wave with CROSS-CHUNK alive compaction.

    Returns the [len(chunk_ids) * chunk_size, 3] radiance rows of chunks
    ``chunk_ids`` (default: the whole wave) in chunk-major order — the
    sequential caller crops the pad tail; the sharded caller passes this
    device's round-robin ids and compaction stays shard-local (zero
    cross-device communication, same as the per-chunk path).

    ``proc_chunk`` (default ``chunk_size``) sets the bounce PROCESSING
    granularity independently of the RNG chunk: randomness and primaries
    stay keyed by the original (chunk_size-sized chunk, lane), so the
    image is invariant to ``proc_chunk`` — a free skip-granularity
    tuning knob (must divide the wave's padded ray count).

    The per-chunk wavefront only skips work when a whole chunk's lanes
    die (the ``lax.cond`` early-out) or a whole tile's die (kernel-level
    culling); occupancy-bound scenes (bright sky, full-frame geometry —
    random/composite) keep ~half their lanes alive SPREAD ACROSS every
    chunk, so every chunk pays every bounce. Here bounces run wave-major:
    before each bounce all N rays are stably partitioned alive-first
    across the WHOLE wave, so live rays pack into the leading chunks and
    the trailing all-dead chunks skip via the existing early-out — the
    CPU reference's pay-only-for-live-paths recursion (ray.rs:85-126) in
    wavefront form.

    Per-ray randomness is gathered from the ray's original (chunk, lane)
    coordinate (:func:`_wave_bounce_randoms`) and every per-lane update
    is position-independent, so both paths follow IDENTICAL sampled
    trajectories; pixel values agree to fp-reassociation level (measured
    maxabs <= 1e-6 at 2spp — XLA fuses the permuted graph differently,
    same class as the documented shard_map drift in parallel/render.py),
    and compact renders themselves are bitwise deterministic in
    (seed, chunk_size).
    """
    n = width * height
    if chunk_ids is None:
        chunk_ids = jnp.arange(-(-n // chunk_size))
    n_chunks = chunk_ids.shape[0]
    n_pad = n_chunks * chunk_size
    pc = proc_chunk or chunk_size
    if n_pad % pc:
        raise ValueError(f"proc_chunk {pc} must divide the wave's "
                         f"padded ray count {n_pad}")

    def prim(cid):
        o, d, t, _ = cam_ops.camera_rays_for_chunk(
            scene.camera, wkey, cid, chunk_size, width, height)
        return o, d, t

    o, d, t = lax.map(prim, chunk_ids)
    o = o.reshape(n_pad, 3)
    d = d.reshape(n_pad, 3)
    t = t.reshape(n_pad)
    L = jnp.zeros((n_pad, 3), o.dtype)
    beta = jnp.ones((n_pad, 3), o.dtype)
    alive = jnp.ones((n_pad,), bool)
    rid = jnp.arange(n_pad, dtype=jnp.int32)

    def wave_bounce(carry, b):
        o, d, t, L, beta, alive, rid = carry
        # stable alive-first partition over the whole wave (pad lanes —
        # rid >= n — ride along like any other ray): two cumsums + one
        # scatter instead of a full [N] sort
        n_alive = jnp.sum(alive)
        dest = jnp.where(alive, jnp.cumsum(alive) - 1,
                         n_alive + jnp.cumsum(~alive) - 1)
        perm = jnp.zeros_like(rid).at[dest].set(
            jnp.arange(rid.shape[0], dtype=rid.dtype))
        o, d, t, L, beta, alive, rid = (
            x[perm] for x in (o, d, t, L, beta, alive, rid))
        ub, gb, mu = _wave_bounce_randoms(scene, wkey, chunk_ids,
                                          chunk_size, b, dtype=o.dtype)
        rand = (ub[rid], gb[rid], mu[rid])

        def chunk_bounce(args):
            co, cd, ct, cL, cb, ca, cub, cgb, cmu = args
            return _bounce(scene, (co, cd, ct, cL, cb, ca), None,
                           rand=(cub, cgb, cmu))

        rs = lambda x: x.reshape((n_pad // pc, pc) + x.shape[1:])  # noqa: E731
        outs = lax.map(chunk_bounce,
                       tuple(map(rs, (o, d, t, L, beta, alive) + rand)))
        o, d, t, L, beta, alive = (
            x.reshape((n_pad,) + x.shape[2:]) for x in outs)
        return (o, d, t, L, beta, alive, rid), None

    body = wave_bounce
    if remat:
        policy = jax.checkpoint_policies.save_only_these_names(
            *_save_names(scene))
        body = jax.checkpoint(wave_bounce, policy=policy)

    carry, _ = lax.scan(lambda c, b: body(c, b),
                        (o, d, t, L, beta, alive, rid),
                        jnp.arange(depth))
    L, rid = carry[3], carry[6]
    # undo the accumulated permutation: scatter L back to chunk-major order
    return jnp.zeros_like(L).at[rid].set(L)


def render_chunk(scene, wkey, chunk_id, chunk_size: int,
                 width: int, height: int, depth: int = MAX_DEPTH,
                 remat: bool = True):
    """Radiance for one global pixel chunk of one sample wave — [C,3].

    The unit of work for both the sequential and the sharded renderer:
    all randomness is derived from (wave key, global chunk id), so *who*
    computes a chunk (which device, which loop iteration) never changes
    its value.
    """
    o, d, t, ckey = cam_ops.camera_rays_for_chunk(
        scene.camera, wkey, chunk_id, chunk_size, width, height)
    return trace_rays(scene, o, d, t, rngu.stream(ckey, rngu.CHUNK),
                      depth, remat)


def render_waves(scene, width: int, height: int, key,
                 wave_start, n_waves: int, depth: int = MAX_DEPTH,
                 chunk_size: int = 32768, remat: bool = True, acc0=None,
                 compact: bool = False, proc_chunk: int | None = None):
    """Sum of ``n_waves`` one-sample-per-pixel radiance images added onto
    ``acc0`` (zeros if None), [H,W,3].

    ``wave_start`` may be a traced int — wave w uses fold_in(key, w), so
    checkpoint/resume is *bitwise exact*: accumulating waves [0,k) and then
    continuing with ``acc0=partial, wave_start=k`` reproduces the monolithic
    run's float-add order ``(((w0+w1)+w2)+...)`` exactly.

    ``compact=True`` runs each wave bounce-major with cross-chunk alive
    compaction (:func:`trace_wave_compact`) — same image, fewer live
    chunks per bounce on occupancy-bound scenes.
    """
    n = width * height
    n_chunks = -(-n // chunk_size)
    n_pad = n_chunks * chunk_size

    def one_wave(wave_i):
        wkey = rngu.wave_key(key, wave_i)
        if compact:
            rows = trace_wave_compact(scene, wkey, width, height, depth,
                                      chunk_size, remat,
                                      proc_chunk=proc_chunk)[:n]
            return cam_ops.image_from_positions(rows, width, height)
        _, L = lax.scan(
            lambda _, c: (0, render_chunk(scene, wkey, c, chunk_size,
                                          width, height, depth, remat)),
            0, jnp.arange(n_chunks))
        return cam_ops.image_from_positions(L.reshape(n_pad, 3)[:n],
                                            width, height)

    def body(acc, i):
        return acc + one_wave(wave_start + i), None

    if acc0 is None:
        acc0 = jnp.zeros((height, width, 3), jnp.float32)
    if n_waves == 1:
        return acc0 + one_wave(wave_start)
    acc, _ = lax.scan(body, acc0, jnp.arange(n_waves))
    return acc


def render_image(scene, width: int, height: int, spp: int, key,
                 depth: int = MAX_DEPTH, chunk_size: int = 32768,
                 remat: bool = True):
    """Mean radiance image [H,W,3] (pre-tonemap), row y=0 at the top of the
    camera frame; utils.image applies the reference's vertical flip at
    write time (main.rs:108)."""
    acc = render_waves(scene, width, height, key, 0, spp, depth,
                       chunk_size, remat)
    return acc / spp
