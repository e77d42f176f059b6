"""Sharded wavefront rendering over a device mesh.

Design (SURVEY.md §2 "Parallelism & communication"):

  * the flat pixel axis is cut into fixed-size chunks; chunk ``c`` of wave
    ``w`` is a pure function of ``(key, w, c)`` (ops/integrator.render_chunk),
    so chunks can be dealt to devices in any layout without changing a bit
    of the output — device d of D owns chunks ``{c : c mod D == d}``;
  * the scene is replicated (tiny next to HBM); each device accumulates
    its own pixel slice — the cross-device communication for a forward
    render is exactly ZERO (the reference serialized every pixel write
    through a ``Mutex``, main.rs:84-112);
  * under ``jax.grad``, shard_map's transpose turns the replicated scene
    into a ``psum`` of per-device scene cotangents — the gradient
    all-reduce, generated by the compiler (NCCL on GPUs);
  * round-robin chunk dealing means the padded tail chunk is the only
    imbalance: work is within one chunk of perfectly even.

Bitwise exactness: a D-device render sums each device's chunks in local
order then adds shards disjointly (pixel-disjoint writes, no reduction),
so every pixel's value is the sum of its own chunks only. Renders are
bitwise identical across device counts D >= 2 (every mesh size compiles
the same shard body). Against the SEQUENTIAL renderer the guarantee is
weaker for triangle scenes: XLA may fuse the [C,10]@[10,4T] Plücker
contraction differently inside shard_map than in the plain program,
reassociating the 10-term dot — observed <=5e-6 drift on ~3% of pixels
on the CPU (tests/test_composite.py pins it). Sphere/quad-only scenes have stayed
bitwise vs sequential in practice (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from rust_ray_tracer_tpu.ops.integrator import MAX_DEPTH, render_chunk
from rust_ray_tracer_tpu.utils import rng as rngu

from rust_ray_tracer_tpu.parallel.mesh import RAY_AXIS


def _wave_shard(scene, wkey, width, height, depth, chunk_size, n_chunks,
                remat, compact=False):
    """Per-device body: render this device's round-robin chunks.

    Returns the device's [chunks_per_dev * chunk_size, 3] pixel slice of a
    chunk-INTERLEAVED pixel layout (reassembled by the caller).

    ``compact=True`` runs the device's chunk set bounce-major with
    SHARD-LOCAL alive compaction (ops/integrator.trace_wave_compact) —
    still zero cross-device communication, and per-ray randomness is
    keyed by the global chunk id, so the result is the same pixel slice.
    """
    d = lax.axis_index(RAY_AXIS)
    n_dev = lax.axis_size(RAY_AXIS)
    cpd = n_chunks // n_dev

    if compact:
        from rust_ray_tracer_tpu.ops.integrator import trace_wave_compact
        ids = jnp.arange(cpd) * n_dev + d   # this device's global chunks
        return trace_wave_compact(scene, wkey, width, height, depth,
                                  chunk_size, remat, chunk_ids=ids)

    def body(i):
        c = i * n_dev + d          # round-robin global chunk id
        return render_chunk(scene, wkey, c, chunk_size, width, height,
                            depth, remat)

    return lax.map(body, jnp.arange(cpd)).reshape(cpd * chunk_size, 3)


def render_waves_sharded(scene, width: int, height: int, key, wave_start,
                         n_waves: int, mesh: Mesh,
                         depth: int = MAX_DEPTH, chunk_size: int = 8192,
                         remat: bool = True, acc0=None,
                         compact: bool = False):
    """Sharded counterpart of ``ops.integrator.render_waves`` — [H,W,3].

    Output is bitwise identical to the sequential renderer for the same
    ``(key, chunk_size)`` on any device count that divides the chunk count
    (chunk count is padded up to a multiple of the mesh size).
    """
    n = width * height
    n_dev = mesh.devices.size
    n_chunks = -(-n // chunk_size)
    n_chunks = -(-n_chunks // n_dev) * n_dev     # multiple of mesh size
    n_pad = n_chunks * chunk_size

    fn = shard_map(
        partial(_wave_shard, width=width, height=height, depth=depth,
                chunk_size=chunk_size, n_chunks=n_chunks, remat=remat,
                compact=compact),
        mesh=mesh,
        in_specs=(P(), P()),          # scene + key replicated
        out_specs=P(RAY_AXIS),        # pixel slices concatenated
        # varying-manual-axes tracking rejects the bounce scan (replicated
        # scene + per-device rays mix in the carry); disabling it only
        # drops a replication optimization — transposition still psums
        # the scene cotangents
        check_vma=False,
    )

    def one_wave(wave_i):
        flat = fn(scene, rngu.wave_key(key, wave_i))    # [n_pad, 3]
        # undo the round-robin interleave: shard d, local chunk i holds
        # global chunk i*n_dev + d
        cpd = n_chunks // mesh.devices.size
        img = flat.reshape(mesh.devices.size, cpd, chunk_size, 3)
        img = img.transpose(1, 0, 2, 3).reshape(n_pad, 3)
        from rust_ray_tracer_tpu.ops import camera as cam_ops
        return cam_ops.image_from_positions(img[:n], width, height)

    if acc0 is None:
        acc0 = jnp.zeros((height, width, 3), jnp.float32)
    if n_waves == 1:
        return acc0 + one_wave(wave_start)

    def body(acc, i):
        return acc + one_wave(wave_start + i), None

    acc, _ = lax.scan(body, acc0, jnp.arange(n_waves))
    return acc


def render_image_sharded(scene, width: int, height: int, spp: int, key,
                         mesh: Mesh, depth: int = MAX_DEPTH,
                         chunk_size: int = 8192, remat: bool = True):
    """Mean radiance image [H,W,3], rays sharded over ``mesh``."""
    acc = render_waves_sharded(scene, width, height, key, 0, spp, mesh,
                               depth, chunk_size, remat)
    return acc / spp


def replicate_scene(scene, mesh: Mesh):
    """Place every scene leaf replicated on the mesh (explicit device_put
    so repeated renders don't re-transfer host arrays)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)
