"""Perlin gradient noise, batched over rays.

Counterpart of ``/root/reference/src/material/perlin.rs``: 256-entry random
gradient table + three xor-combined permutation tables (perlin.rs:44-51),
Hermite-smoothed trilinear gradient interpolation (perlin.rs:86-105), and the
``turb`` fractal sum (perlin.rs:58-71). The tables live in ``SceneData`` and
are seeded at scene compile time (the reference's are unseeded thread_rng —
irreproducible by construction, so tests inject fixed tables instead of
comparing images).

Gather discipline: the obvious formulation — 8 corners x 4 table
lookups x 7 octaves unrolled in Python — compiles to ~220 separate
[C]-sized gather fusions per noise texture, each paying its own launch.
Batched here:
all octaves' corner indices gather at once — 3 perm-table gathers of
[..., D, 2] plus ONE gradient gather of [..., D, 8] per ``turb`` — and
the per-corner/per-octave accumulation then walks Python loops over
SLICES of those batched results in the original order, so every float
op sequence (and hence the image) is bitwise unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

_MASK = 255  # N - 1 for N=256 (perlin.rs:47-50)


def _corner_tables(px, py, pz, perlin_vec, ijk):
    """Batched table lookups for the 8 cell corners of ``ijk`` [..., 3]:
    returns grad [..., 8, 3] with corner order (di, dj, dk) nested as
    di*4 + dj*2 + dk — the loop order of perlin.rs:92-94."""
    two = jnp.arange(2, dtype=ijk.dtype)
    hx = px[(ijk[..., 0:1] + two) & _MASK]        # [..., 2]
    hy = py[(ijk[..., 1:2] + two) & _MASK]
    hz = pz[(ijk[..., 2:3] + two) & _MASK]
    hash8 = (hx[..., :, None, None] ^ hy[..., None, :, None]
             ^ hz[..., None, None, :])            # [..., 2, 2, 2]
    hash8 = hash8.reshape(hash8.shape[:-3] + (8,))
    return perlin_vec[hash8]                      # [..., 8, 3]


def noise(perlin_vec, px, py, pz, p):
    """Gradient noise at points p [...,3] -> [...]. Range roughly [-1, 1]."""
    pf = jnp.floor(p)
    uvw = p - pf
    ijk = pf.astype(jnp.int32)

    # Hermite smoothing (perlin.rs:87-89)
    s = uvw * uvw * (3.0 - 2.0 * uvw)

    grad8 = _corner_tables(px, py, pz, perlin_vec, ijk)
    acc = jnp.zeros(p.shape[:-1], p.dtype)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                grad = grad8[..., di * 4 + dj * 2 + dk, :]
                weight = uvw - jnp.asarray([di, dj, dk], p.dtype)
                w = ((di * s[..., 0] + (1 - di) * (1 - s[..., 0]))
                     * (dj * s[..., 1] + (1 - dj) * (1 - s[..., 1]))
                     * (dk * s[..., 2] + (1 - dk) * (1 - s[..., 2])))
                acc = acc + w * jnp.sum(grad * weight, axis=-1)
    return acc


def turb(perlin_vec, px, py, pz, p, depth: int = 7):
    """Fractal turbulence |sum w_i * noise(2^i p)| (perlin.rs:58-71).

    All ``depth`` octaves' noise evaluates in ONE batched noise() call
    (octave scales 2^i are exact powers of two, so ``p * 2.0**i`` is
    bitwise the reference's iterative doubling); the weighted sum then
    accumulates octave slices sequentially in the original order."""
    scales = (2.0 ** jnp.arange(depth, dtype=p.dtype))[:, None]
    p_oct = p[..., None, :] * scales              # [..., depth, 3]
    n_oct = noise(perlin_vec, px, py, pz, p_oct)  # [..., depth]
    acc = jnp.zeros(p.shape[:-1], p.dtype)
    weight = 1.0
    for i in range(depth):
        acc = acc + weight * n_oct[..., i]
        weight *= 0.5
    return jnp.abs(acc)
