"""Pinhole camera: batched ray generation.

Batched counterpart of the reference's ``src/camera.rs``. The reference
generates one ray at a time from a ``camera_to_world: Affine3A`` and a
vfov-derived ``scale = tan(vfov/2)`` (camera.rs:18-39,56-69); here ray
generation is a single batched affine transform over all (pixel, sample)
coordinates — elementwise work that XLA fuses into the downstream
intersection.

Reference conventions replicated exactly:
  * ndc: px = (2*(x+0.5)/W - 1) * scale * aspect,  py likewise with H
    (camera.rs:59-60); the caller passes x = pixel_x + U[0,1) jitter
    (main.rs:92-94).
  * ray point = c2w @ (px, py, -1); origin = c2w @ 0; dir = point - origin
    (unnormalized! camera.rs:62-68 — hit math everywhere divides by
    |d|^2-style terms, so this matters).
  * per-ray shutter time ~ U[time0, time1) (camera.rs:67).
  * the builders pass glam's look_at_rh (a WORLD->VIEW matrix) as
    camera_to_world (scene.rs:418 etc.) — a reference quirk we replicate in
    models/builders.py, not here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Chunks walk the image in Morton (Z-curve) pixel order, not scan-line
# order: a block of consecutive rays then covers a compact pixel square
# instead of part of an image row, so its frustum is tight and the GPU
# search's per-block cluster cull (ops/tri_search.py) rejects more
# geometry.
# Determinism is unaffected (the pixel->chunk map is a pure function of
# (width, height)); it DOES change which jitter/path randoms each pixel
# draws, i.e. renders differ from scan-order builds like a seed change.
MORTON_CHUNKS = True


@functools.lru_cache(maxsize=16)
def _pixel_order(width: int, height: int):
    """(perm, inv) int32: perm[pos] = flat pixel id (y*W+x) of chunk
    position pos along the Morton curve; inv[pixel] = its position."""
    def spread(v):
        v = v.astype(np.uint32) & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    gx, gy = np.meshgrid(np.arange(width), np.arange(height))
    code = spread(gx) | (spread(gy) << np.uint32(1))
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def pixel_id_for_position(pos, width: int, height: int):
    """Flat pixel id for flat chunk position(s) ``pos`` (traced ok)."""
    if not MORTON_CHUNKS:
        return pos
    perm, _ = _pixel_order(width, height)
    return jnp.asarray(perm)[pos]


@functools.lru_cache(maxsize=16)
def _pixel_order_chunked(width: int, height: int, chunk_size: int,
                         morton: bool = True):
    """[n_chunks, chunk_size] pixel ids along the Morton curve, the pad
    tail clamped to the last pixel (same values as
    ``pixel_id_for_position(min(pos, n-1))``). Indexing one row by a
    traced chunk id is a dynamic-slice rather than a gather over every
    pixel of the wave.

    ``morton`` mirrors the module global MORTON_CHUNKS and is part of
    the cache key: the call site passes the flag's live value, so
    toggling it can never serve a stale ordering that desyncs from
    image_from_positions (which also reads it live)."""
    n = width * height
    n_chunks = -(-n // chunk_size)
    if morton:
        perm, _ = _pixel_order(width, height)
    else:
        perm = np.arange(n, dtype=np.int32)
    pad = np.full(n_chunks * chunk_size - n, perm[-1], np.int32)
    return np.concatenate([perm, pad]).reshape(n_chunks, chunk_size)


def image_from_positions(flat, width: int, height: int):
    """[n,3] position-ordered radiance -> [H,W,3] image."""
    if MORTON_CHUNKS:
        _, inv = _pixel_order(width, height)
        flat = flat[jnp.asarray(inv)]
    return flat.reshape(height, width, 3)


class CameraData(NamedTuple):
    """Camera parameters as a differentiable pytree leaf set.

    c2w is a 3x4 affine (rotation|translation), row-vector-free convention:
    world_p = c2w[:, :3] @ p + c2w[:, 3].
    """

    c2w: jnp.ndarray          # [3, 4] float32
    scale: jnp.ndarray        # [] tan(vfov_deg/2 in radians)
    aspect: jnp.ndarray       # [] aspect ratio (width/height)
    time0: jnp.ndarray        # [] shutter open
    time1: jnp.ndarray        # [] shutter close


def make_camera(c2w, vfov_deg, aspect, time0=0.0, time1=1.0) -> CameraData:
    c2w = jnp.asarray(c2w, jnp.float32).reshape(3, 4)
    scale = jnp.tan(jnp.deg2rad(jnp.asarray(vfov_deg, jnp.float32)) * 0.5)
    return CameraData(
        c2w=c2w,
        scale=scale,
        aspect=jnp.asarray(aspect, jnp.float32),
        time0=jnp.asarray(time0, jnp.float32),
        time1=jnp.asarray(time1, jnp.float32),
    )


def look_at_rh(eye, center, up) -> jnp.ndarray:
    """glam-compatible ``Affine3A::look_at_rh`` (a world->view matrix).

    The reference feeds this matrix in as "camera_to_world"
    (scene.rs:417-418) — the pose quirk is part of its image output, so the
    procedural scene builders reproduce it bit-for-bit.
    """
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = center - eye
    f = f / jnp.linalg.norm(f)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    rot = jnp.stack([s, u, -f], axis=0)            # [3,3]
    trans = -rot @ eye                              # [3]
    return jnp.concatenate([rot, trans[:, None]], axis=1)  # [3,4]


def transform_point(c2w: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a [3,4] affine to [..., 3] points.

    Written as broadcast multiply-adds, NOT a matmul: an f32 contraction
    at default precision may run in reduced precision on an accelerator
    (TF32 on the GPU) and quantize ray directions; the elementwise form
    is exact f32 and fuses into downstream intersection anyway.
    """
    return jnp.sum(p[..., None, :] * c2w[:, :3], axis=-1) + c2w[:, 3]


def generate_rays(cam: CameraData, x, y, width: int, height: int, time_u):
    """Batched ``Camera::get_ray`` (camera.rs:56-69).

    Args:
      cam: camera parameters.
      x, y: [...] float pixel coordinates (already jittered by the caller).
      width, height: image dims in pixels (static ints).
      time_u: [...] uniforms in [0,1) mapped to [time0, time1).

    Returns (origins [...,3], directions [...,3], times [...]).
    """
    px = (2.0 * (x + 0.5) / width - 1.0) * cam.scale * cam.aspect
    py = (2.0 * (y + 0.5) / height - 1.0) * cam.scale
    ndc = jnp.stack([px, py, -jnp.ones_like(px)], axis=-1)
    origin = cam.c2w[:, 3]
    point = transform_point(cam.c2w, ndc)
    direction = point - origin
    times = cam.time0 + time_u * (cam.time1 - cam.time0)
    origins = jnp.broadcast_to(origin, direction.shape)
    return origins, direction, times


def camera_rays_for_chunk(cam: CameraData, wkey: jax.Array, chunk_id,
                          chunk_size: int, width: int, height: int):
    """Primary rays for one chunk of ``chunk_size`` pixels of a sample wave.

    Chunk ``c`` covers flat chunk POSITIONS ``[c*chunk_size,
    (c+1)*chunk_size)``; position -> pixel follows the Morton curve
    (``MORTON_CHUNKS``: a kernel ray tile = a compact pixel square, so
    tile-level cluster culling bites). Positions past the image (the pad
    tail of the last chunk) clamp to the last position — real geometry,
    so no NaNs enter the gradient path; callers slice the pad off.

    Randomness (jitter + shutter time) is drawn from keys folded with the
    *global* chunk id, so any partition of chunks over devices or loop
    steps yields bitwise-identical rays — this is what makes the sharded
    renderer exactly equal to the single-chip one. The vertical flip at
    image write time (main.rs:108) is handled by utils/image.py, not here.
    """
    from rust_ray_tracer_tpu.utils import rng as rngu

    pix = jnp.asarray(_pixel_order_chunked(width, height, chunk_size,
                                           MORTON_CHUNKS))[chunk_id]
    yy = (pix // width).astype(jnp.float32)
    xx = (pix % width).astype(jnp.float32)
    ckey = jax.random.fold_in(wkey, chunk_id)
    jitter = jax.random.uniform(rngu.stream(ckey, rngu.JITTER),
                                (chunk_size, 2), dtype=jnp.float32)
    time_u = jax.random.uniform(rngu.stream(ckey, rngu.TIME),
                                (chunk_size,), dtype=jnp.float32)
    o, d, t = generate_rays(cam, xx + jitter[:, 0], yy + jitter[:, 1],
                            width, height, time_u)
    return o, d, t, ckey
