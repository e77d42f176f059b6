"""Closest-hit triangle search as one Pallas kernel for the GPU (Triton).

The XLA form (``intersect._tri_candidates``) evaluates every (ray,
triangle) pair as four ``[C,T]`` f32 products, writes them to device
memory and reads them back for the validity mask and the argmin — about
5 FLOP per byte, so memory-bound. This kernel writes only the ``[C]``
winners:

* one program owns ``BLOCK_RAYS`` rays and walks a contiguous span of
  the Morton-ordered triangle clusters (``models/scene.py``) in a
  ``lax.fori_loop``. A bounce has only ~10^4 rays, so the clusters are
  split over up to ``TARGET_PROGRAMS / ray blocks`` programs per ray
  block to fill the card; the per-split winners ([S, C]) are reduced by
  one small XLA argmin (lowest split wins ties = lowest index);
* each cluster's AABB is slab-tested against the block's rays inside the
  program, and the cluster is skipped when no ray of the block can enter
  it before its current best hit (conservative: the box is widened by
  ``BOX_EPS``, so culling never changes the winner);
* inside a live cluster the Plücker quantities — linear in the ray
  features ``[o, d, o×d, 1]`` (``intersect`` module docstring) — are
  evaluated ``BLOCK_TRIS`` triangles at a time as f32 FMAs on the CUDA
  cores. No ``pl.dot``: K=10 is far too thin for the tensor cores, and
  TF32's 10-bit mantissa would pick the wrong surface where two are close
  (the Cornell lamp and ceiling are 0.2% apart in t);
* the running ``(t, index)`` minimum stays in registers; ``<`` against
  the running best and clusters walked in index order make the lowest
  index win on equal ``t``, as in the XLA argmin.

The search sits in the detached phase 1 of ``intersect_select``, so it
needs no VJP: gradients flow through the phase-2 recompute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

TRI_DET_EPS = 1e-5      # triangle.rs:42 (scale-invariant form, see intersect)
BOX_EPS = 1e-3          # absolute AABB widening of the cluster cull
BLOCK_RAYS = 64         # rays per program
BLOCK_TRIS = 32         # triangles per inner tile
NUM_WARPS = 4
NUM_STAGES = 2
TARGET_PROGRAMS = 1024  # ray blocks x cluster splits to aim for

# rows of the packed triangle table (pack_tris): the nonzero Plücker
# coefficients of _tri_coeffs, grouped by the ray feature they multiply
_DET_D = 0              # 3 rows: det   = d·(-n̂)
_U_D, _U_M = 3, 6       # 3+3:    u_num = d·a_u + m·b_u
_V_D, _V_M = 9, 12      # 3+3:    v_num = d·a_v + m·b_v
_T_O, _T_C = 15, 18     # 3+1:    t_num = o·n̂ + c_t
_DBL = 19               # double-sided flag (1.0 / 0.0)
N_ROWS = 20


def pack_tris(det_c, u_c, v_c, t_c, double):
    """[N_ROWS, T] kernel table from ``intersect._tri_coeffs``' four
    [10, T] matrices (feature order o, d, o×d, 1) and the [T] flags."""
    return jnp.concatenate(
        [det_c[3:6], u_c[3:6], u_c[6:9], v_c[3:6], v_c[6:9],
         t_c[0:3], t_c[9:10], double.astype(jnp.float32)[None]], axis=0)


def _kernel(ray_ref, tri_ref, box_ref, t_out, i_out, *, n_clusters,
            per_split, cluster_w):
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    tmin, tmax = ray_ref[6, :], ray_ref[7, :]
    mx = oy * dz - oz * dy                          # m = o × d
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    eps = TRI_DET_EPS * jnp.sqrt(dx * dx + dy * dy + dz * dz)
    live = tmax > tmin

    # per-axis reciprocal for the slab test; near-zero components are
    # handled as "origin must lie inside the slab"
    axes = []
    for oa, da in ((ox, dx), (oy, dy), (oz, dz)):
        small = jnp.abs(da) < 1e-12
        axes.append((oa, small, 1.0 / jnp.where(small, 1.0, da)))

    col = lambda x: x[:, None]                      # noqa: E731
    sub_tiles = cluster_w // BLOCK_TRIS

    def tile(j, carry):
        best_t, best_i = carry
        base = j * BLOCK_TRIS
        row = lambda r: tri_ref[r, pl.ds(base, BLOCK_TRIS)][None, :]  # noqa: E731
        det = (col(dx) * row(_DET_D) + col(dy) * row(_DET_D + 1)
               + col(dz) * row(_DET_D + 2))
        u_num = (col(dx) * row(_U_D) + col(dy) * row(_U_D + 1)
                 + col(dz) * row(_U_D + 2) + col(mx) * row(_U_M)
                 + col(my) * row(_U_M + 1) + col(mz) * row(_U_M + 2))
        v_num = (col(dx) * row(_V_D) + col(dy) * row(_V_D + 1)
                 + col(dz) * row(_V_D + 2) + col(mx) * row(_V_M)
                 + col(my) * row(_V_M + 1) + col(mz) * row(_V_M + 2))
        t_num = (col(ox) * row(_T_O) + col(oy) * row(_T_O + 1)
                 + col(oz) * row(_T_O + 2) + row(_T_C))
        e = col(eps)
        side_ok = (det > e) | ((det < -e) & (row(_DBL) > 0.5))
        inv = 1.0 / jnp.where(jnp.abs(det) > e, det, 1.0)
        u = u_num * inv
        v = v_num * inv
        t = t_num * inv
        valid = (side_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (v < 1.0 - u) & (t >= col(tmin)) & (t <= col(tmax)))
        tt = jnp.where(valid, t, jnp.inf)
        loc_t = jnp.min(tt, axis=1)
        loc_i = jnp.argmin(tt, axis=1).astype(jnp.int32) + base
        better = loc_t < best_t
        return (jnp.where(better, loc_t, best_t),
                jnp.where(better, loc_i, best_i))

    def cluster(k, carry):
        best_t, _ = carry
        lo = [box_ref[a, k] - BOX_EPS for a in range(3)]
        hi = [box_ref[3 + a, k] + BOX_EPS for a in range(3)]
        enter = jnp.full_like(tmin, -jnp.inf)
        exit_ = jnp.full_like(tmin, jnp.inf)
        inside = live
        for a, (oa, small, inv) in enumerate(axes):
            t0 = (lo[a] - oa) * inv
            t1 = (hi[a] - oa) * inv
            enter = jnp.maximum(
                enter, jnp.where(small, -jnp.inf, jnp.minimum(t0, t1)))
            exit_ = jnp.minimum(
                exit_, jnp.where(small, jnp.inf, jnp.maximum(t0, t1)))
            inside = inside & (~small | ((oa >= lo[a]) & (oa <= hi[a])))
        # an empty cluster (all padding) carries an inverted box
        nonempty = (lo[0] <= hi[0]) & (lo[1] <= hi[1]) & (lo[2] <= hi[2])
        enters = (inside & nonempty & (enter <= exit_) & (exit_ >= tmin)
                  & (enter <= jnp.minimum(tmax, best_t)))
        return lax.cond(
            jnp.sum(enters.astype(jnp.int32)) > 0,
            lambda c: lax.fori_loop(k * sub_tiles, (k + 1) * sub_tiles,
                                    tile, c),
            lambda c: c, carry)

    first = pl.program_id(1) * per_split
    best_t, best_i = lax.fori_loop(
        first, jnp.minimum(first + per_split, n_clusters), cluster,
        (jnp.full_like(tmin, jnp.inf), jnp.zeros(tmin.shape, jnp.int32)))
    t_out[...] = best_t
    i_out[...] = best_i


def search(o, d, t_min, t_max, tris, cl_min, cl_max, *,
           interpret: bool = False):
    """Best (t, triangle index) per ray — same contract as
    ``intersect._tri_candidates``' XLA form.

    Args:
      o, d: [C,3] rays; t_min, t_max: [C] (``t_max <= t_min`` = dead lane).
      tris: [N_ROWS, T] from :func:`pack_tris`; T is a multiple of the
        cluster count, zero-coefficient pad triangles never hit.
      cl_min, cl_max: [K,3] cluster AABBs (inverted = empty cluster).
      interpret: run the Pallas interpreter (CPU tests only).

    Returns (best_t [C] — inf on miss, best_idx [C] int32).
    """
    c = o.shape[0]
    t_n = tris.shape[1]
    k = cl_min.shape[0]
    cluster_w = t_n // k
    if cluster_w * k != t_n or cluster_w % BLOCK_TRIS:
        raise ValueError(f"{t_n} triangles do not split into {k} clusters "
                         f"of a multiple of {BLOCK_TRIS}")
    cp = -(-c // BLOCK_RAYS) * BLOCK_RAYS
    rays = jnp.concatenate(
        [o.T, d.T, t_min[None], t_max[None]], axis=0).astype(jnp.float32)
    # pad rays get a collapsed window (0, -inf): they enter no cluster
    pad = jnp.zeros((8, cp - c), jnp.float32).at[7].set(-jnp.inf)
    rays = jnp.concatenate([rays, pad], axis=1)
    boxes = jnp.concatenate([cl_min.T, cl_max.T], axis=0)      # [6, K]

    n_blocks = cp // BLOCK_RAYS
    per_split = -(-k // max(1, min(k, TARGET_PROGRAMS // n_blocks)))
    n_splits = -(-k // per_split)
    kern = functools.partial(_kernel, n_clusters=k, per_split=per_split,
                             cluster_w=cluster_w)
    block = pl.BlockSpec((None, BLOCK_RAYS), lambda i, j: (j, i))
    split_t, split_i = pl.pallas_call(
        kern,
        grid=(n_blocks, n_splits),
        in_specs=[pl.BlockSpec((8, BLOCK_RAYS), lambda i, j: (0, i)),
                  pl.no_block_spec, pl.no_block_spec],
        out_specs=[block, block],
        out_shape=[jax.ShapeDtypeStruct((n_splits, cp), jnp.float32),
                   jax.ShapeDtypeStruct((n_splits, cp), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="tri_search",
    )(rays, tris, boxes)
    s = jnp.argmin(split_t, axis=0)[None]
    best_t = jnp.take_along_axis(split_t, s, axis=0)[0]
    best_i = jnp.take_along_axis(split_i, s, axis=0)[0]
    return best_t[:c], best_i[:c]
