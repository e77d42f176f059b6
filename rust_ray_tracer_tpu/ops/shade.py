"""Branchless material shading + scatter sampling for one wavefront bounce.

Counterpart of ``/root/reference/src/material/mod.rs`` (the five materials)
and the scatter/PDF plumbing inside ``ray_color`` (``ray.rs:90-120``). The
reference virtual-dispatches per hit; on a vector machine we evaluate every
material's response for every ray and select by the gathered material kind —
five kinds is far cheaper than sorting rays by material.

Estimator mapping (recursive -> iterative): ``ray_color`` computes
``emitted + scattering_pdf * attenuation * L(next) / pdf`` for diffuse and
``attenuation * L(next)`` for specular (ray.rs:93-120). Iteratively the
integrator carries per-ray throughput ``beta`` and accumulates
``L += beta * emitted``; this module returns per-bounce (emitted, weight,
new direction, continue-mask) where ``weight`` is the factor multiplying
``beta``.

Gradient discipline (detached sampling): randomly *sampled* directions
(cosine / light / fuzz ball / isotropic ball draws) are detached, while
deterministic specular transforms (mirror reflection, Snell refraction) stay
attached — so material, camera and vertex gradients flow through BSDF values,
pdf evaluations and specular chains, and never through the sampling decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rust_ray_tracer_tpu.models.scene import (
    MAT_DIELECTRIC, MAT_ISOTROPIC, MAT_LAMBERTIAN, MAT_LIGHT, MAT_METAL)
from rust_ray_tracer_tpu.ops import linalg as la
from rust_ray_tracer_tpu.ops import sampling
from jax.ad_checkpoint import checkpoint_name
from rust_ray_tracer_tpu.ops.texture import texture_value
from rust_ray_tracer_tpu.utils import rng as rngu

PDF_FLOOR = 1e-5  # ray.rs:112


class Scatter(NamedTuple):
    emitted: jnp.ndarray    # [C,3] radiance emitted at the hit
    weight: jnp.ndarray     # [C,3] multiplicative throughput factor
    direction: jnp.ndarray  # [C,3] next ray direction
    alive: jnp.ndarray      # [C] continue tracing?


def _rust_max_floor(pdf):
    """pdf.max(1e-5) with Rust's NaN semantics: f32::max(NaN, x) == x
    (ray.rs:112) — a NaN pdf clamps to the floor instead of propagating."""
    return jnp.where(pdf > PDF_FLOOR, pdf, PDF_FLOOR)


def shade(scene, key, d_in, time, hit, rand=None) -> Scatter:
    """One bounce of material evaluation for rays that hit something.

    Args:
      scene: SceneData.
      key: per-(wave, chunk, bounce) PRNG key.
      d_in: [C,3] incoming (unnormalized) ray directions.
      time: [C] ray times (unused by materials, kept by scattered rays).
      hit: intersect.Hit for these rays.
      rand: optional externally drawn ``(ub [C,9], gb [C,6])`` random
        blocks (the compacting wavefront gathers per-ray randomness
        across chunks — integrator.trace_wave_compact); drawn here from
        ``key`` when None.

    Outputs are only meaningful where ``hit.hit``; the integrator masks.

    Randomness is drawn here (one uniform + one normal block — each
    threefry invocation is a separate hash sweep, so seven keyed draws
    became two) and handed to the pure :func:`shade_core`.
    """
    c = d_in.shape[0]
    f32 = d_in.dtype
    kind = scene.mat_kind[hit.mat]
    tex = scene.mat_tex[hit.mat]
    # one packed float gather (-> one scatter-add in backward)
    mat_pack = jnp.stack([scene.mat_fuzz, scene.mat_ior], axis=1)[hit.mat]
    albedo = checkpoint_name(
        texture_value(scene, tex, hit.u, hit.v, hit.p), "albedo")

    # the bounce's entire random budget, keyed by (wave, chunk, bounce)
    # only, so every platform follows identical sampled paths. Named as
    # remat residuals so a policy may reuse the blocks instead of
    # re-sweeping threefry.
    if rand is None:
        ub = jax.random.uniform(rngu.stream(key, rngu.SCATTER), (c, 9),
                                dtype=f32)
        gb = jax.random.normal(rngu.stream(key, rngu.FUZZ), (c, 6),
                               dtype=f32)
    else:
        ub, gb = rand
    ub = checkpoint_name(ub, "shade_rand")
    gb = checkpoint_name(gb, "shade_rand")
    return shade_core(scene, d_in, hit.p, hit.normal, albedo, kind,
                      mat_pack[:, 0], mat_pack[:, 1], ub, gb)


def shade_core(scene, d_in, p, normal, albedo, kind, fuzz, ior,
               ub, gb) -> Scatter:
    """Pure branchless material evaluation (no RNG, no gathers).

    ``ub`` [C,9] uniforms / ``gb`` [C,6] normals are the bounce's entire
    random budget; scene is only read for the light list (everything
    per-ray is already gathered by the caller).

    NOTE the ball radii draw from UNIFORM columns (u7/u8):
    ``uniform_in_ball`` needs U[0,1) for its r ~ U^(1/3); feeding it a
    gaussian (an earlier bug) skews the fuzz/phase distributions.
    """
    c = d_in.shape[0]
    f32 = d_in.dtype
    unit_d = la.normalize(d_in)
    u_scatter = ub[:, 0:2]
    u_coin = ub[:, 2]
    u_mix = ub[:, 3]
    u_pick = ub[:, 4]
    u_light = ub[:, 5:7]
    g_fuzz = gb[:, 0:3]
    g_iso = gb[:, 3:6]
    u_fuzz_r = ub[:, 7]
    u_iso_r = ub[:, 8]

    # =======================================================================
    # Lambertian (material/mod.rs:47-84) + the ray_color mixture
    # (ray.rs:102-120)
    # =======================================================================
    cos_dir = sampling.cosine_sample(normal, u_scatter[:, 0], u_scatter[:, 1])
    if scene.n_lights:
        light_dir = sampling.lights_sample(scene, p, u_pick,
                                           u_light[:, 0], u_light[:, 1])
        lam_dir = jnp.where((u_mix < 0.5)[:, None], cos_dir, light_dir)
        lam_dir = lax.stop_gradient(lam_dir)
        pdf = (0.5 * sampling.cosine_pdf_value(normal, lam_dir)
               + 0.5 * sampling.lights_pdf_value(scene, p, lam_dir))
    else:
        lam_dir = lax.stop_gradient(cos_dir)
        pdf = sampling.cosine_pdf_value(normal, lam_dir)
    pdf = _rust_max_floor(pdf)
    # scattering_pdf = max(cos(n, scattered)/pi, 0) (material/mod.rs:80-83)
    spdf = jnp.maximum(
        la.dot(normal, la.normalize(lam_dir)) / jnp.pi, 0.0)
    lam_weight = albedo * (spdf / pdf)[:, None]

    # =======================================================================
    # Metal (material/mod.rs:86-108)
    # =======================================================================
    reflected = la.reflect(unit_d, normal)
    fuzz_vec = lax.stop_gradient(
        sampling.uniform_in_ball(g_fuzz, u_fuzz_r))
    metal_dir = reflected + fuzz[:, None] * fuzz_vec
    metal_ok = la.dot(metal_dir, normal) > 0.0   # else absorbed (mod.rs:99)

    # =======================================================================
    # Dielectric (material/mod.rs:110-148)
    # =======================================================================
    exiting = la.dot(d_in, normal) > 0.0
    ratio = jnp.where(exiting, ior, 1.0 / ior)
    n_orient = jnp.where(exiting[:, None], -normal, normal)
    cos_theta = jnp.minimum(-la.dot(unit_d, n_orient), 1.0)
    refracted, tir = la.refract(unit_d, n_orient, ratio)
    # QUIRK (replicated): Schlick is fed the unoriented self.ir even for
    # exit rays (mod.rs:130).
    reflect_prob = la.schlick(cos_theta, ior)
    do_reflect = tir | (reflect_prob >= u_coin)
    # reflect() is sign(n)-invariant, so using the outward normal matches
    # the reference's reflect(unit_d, rec.normal) (mod.rs:141).
    diel_dir = jnp.where(do_reflect[:, None], la.reflect(unit_d, normal),
                         refracted)

    # =======================================================================
    # DiffuseLight (material/mod.rs:171-194): emit on front face only
    # =======================================================================
    front = la.dot(d_in, normal) < 0.0
    emitted = jnp.where(((kind == MAT_LIGHT) & front)[:, None], albedo, 0.0)

    # =======================================================================
    # Isotropic (material/mod.rs:196-216): uniform-ball specular scatter
    # =======================================================================
    iso_dir = lax.stop_gradient(
        sampling.uniform_in_ball(g_iso, u_iso_r))

    # ---- select by material kind -----------------------------------------
    one3 = jnp.ones((c, 3), f32)
    direction = jnp.where((kind == MAT_LAMBERTIAN)[:, None], lam_dir,
                jnp.where((kind == MAT_METAL)[:, None], metal_dir,
                jnp.where((kind == MAT_DIELECTRIC)[:, None], diel_dir,
                jnp.where((kind == MAT_ISOTROPIC)[:, None], iso_dir,
                          one3))))
    weight = jnp.where((kind == MAT_LAMBERTIAN)[:, None], lam_weight,
             jnp.where((kind == MAT_METAL)[:, None], albedo,
             jnp.where((kind == MAT_DIELECTRIC)[:, None], one3,
             jnp.where((kind == MAT_ISOTROPIC)[:, None], albedo,
                       jnp.zeros((c, 3), f32)))))
    alive = jnp.where(kind == MAT_METAL, metal_ok, kind != MAT_LIGHT)

    return Scatter(emitted=emitted, weight=weight, direction=direction,
                   alive=alive)
