"""Render checkpoint / resume.

The reference renders one-shot and writes the PNG only at the end
(``/root/reference/src/main.rs:116``) — a crash loses everything. Here the
sample accumulator (sum image + wave count + seed) checkpoints to disk
every N waves and resumes *bitwise exactly*: ``render_waves(acc0=...)``
reproduces the monolithic float-add order (see ops/integrator.py), so a
resumed render is indistinguishable from an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import jax

from rust_ray_tracer_tpu.ops.integrator import MAX_DEPTH, render_waves


@dataclasses.dataclass
class RenderState:
    acc: np.ndarray          # [H,W,3] radiance sum over completed waves
    waves_done: int
    seed: int
    width: int
    height: int
    chunk_size: int
    depth: int = MAX_DEPTH

    @property
    def image(self) -> np.ndarray:
        """Mean radiance so far (pre-tonemap)."""
        return self.acc / max(self.waves_done, 1)


def save_state(path: str, state: RenderState) -> None:
    """Atomic save (write temp + rename) so a crash mid-write never
    corrupts the previous checkpoint."""
    meta = {k: getattr(state, k) for k in
            ("waves_done", "seed", "width", "height", "chunk_size", "depth")}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, acc=np.asarray(state.acc, np.float32),
                     meta=json.dumps(meta))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> RenderState:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return RenderState(acc=z["acc"], **meta)


def render_with_checkpoints(scene, width: int, height: int, spp: int,
                            seed: int, ckpt_path: str,
                            ckpt_every: int = 8, depth: int = MAX_DEPTH,
                            chunk_size: int = 32768, mesh=None,
                            compact: bool = False,
                            progress=None):
    """Render ``spp`` waves, checkpointing every ``ckpt_every`` waves and
    resuming from ``ckpt_path`` if it exists. Returns the mean image.

    ``mesh``: optional device mesh — uses the sharded renderer when given.
    ``progress``: optional callable(waves_done, spp).
    """
    key = jax.random.PRNGKey(seed)
    if os.path.exists(ckpt_path):
        st = load_state(ckpt_path)
        if (st.seed, st.width, st.height, st.chunk_size, st.depth) != \
                (seed, width, height, chunk_size, depth):
            raise ValueError(
                f"checkpoint {ckpt_path} was rendered with different "
                "settings; delete it or change --checkpoint")
    else:
        st = RenderState(acc=np.zeros((height, width, 3), np.float32),
                         waves_done=0, seed=seed, width=width,
                         height=height, chunk_size=chunk_size, depth=depth)

    # ``wave_start``/``acc0`` are TRACED arguments (render_waves derives
    # wave keys by fold_in, so this is exact): every ckpt_every-sized
    # segment shares ONE compiled executable instead of baking the start
    # wave in as a literal and recompiling the full wave program per
    # segment. Only a different-length tail segment triggers a second
    # compile.
    # ``scene`` is a TRACED argument too: closing over it would bake
    # every SceneData array into the executable as a compile-time
    # constant — at 1M-triangle scale that duplicates the tables into
    # the program image, inflating compile time and HBM, instead of
    # passing them as ordinary device buffers.
    if mesh is not None:
        from rust_ray_tracer_tpu.parallel.render import render_waves_sharded

        def segment(scene, acc, start, n):
            return render_waves_sharded(scene, width, height, key, start, n,
                                        mesh, depth, chunk_size, acc0=acc,
                                        compact=compact)
    else:
        def segment(scene, acc, start, n):
            return render_waves(scene, width, height, key, start, n, depth,
                                chunk_size, acc0=acc, compact=compact)

    jitted = {}

    def run(acc, start, n):
        if n not in jitted:
            jitted[n] = jax.jit(
                lambda scene, acc, start: segment(scene, acc, start, n))
        return jitted[n](scene, acc,
                         jax.numpy.asarray(start, jax.numpy.int32))

    acc = jax.numpy.asarray(st.acc)
    done = st.waves_done
    while done < spp:
        n = min(ckpt_every, spp - done)
        acc = run(acc, done, n)
        acc.block_until_ready()
        done += n
        save_state(ckpt_path, RenderState(
            acc=np.asarray(acc), waves_done=done, seed=seed, width=width,
            height=height, chunk_size=chunk_size, depth=depth))
        if progress is not None:
            progress(done, spp)
    return np.asarray(acc) / max(spp, 1)
