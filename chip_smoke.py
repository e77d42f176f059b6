"""Chip smoke test: the renderer's main paths on one GPU, checked.

    python chip_smoke.py                  # one GPU: every phase below
    python chip_smoke.py --four           # four GPUs: the sharded path only
    python chip_smoke.py --rehearse-cpu [--four]
                                          # the same phases at tiny sizes on
                                          # the CPU, Pallas in interpret mode

Phases (one process; a failed phase is reported and the run exits 1):

1. device     — JAX's devices must be GPUs (CPU only under --rehearse-cpu);
                prints the kind, the count and nvidia-smi's name/power limit.
2. native     — rebuilds the C++ host library on this machine and checks
                its Morton sort against NumPy.
3. cli        — ``utils/cli.main`` in-process: final_scene at 1920x1080,
                then cornell_triangle at 512x512; PNGs written, radiance
                finite, mean inside a band.
4. train      — 5 jitted value_and_grad + Adam steps on the flagship mesh
                at 512x288, 4 spp, depth 4, chunk 9216.
5. vs_cpu     — cornell_triangle and final_scene at 128x72 rendered on the
                GPU and on the host CPU with the same keys; relative mean
                error and pixel-flip rate within per-scene budgets.
6. resume     — render_waves(k,0,4) == render_waves(k,2,2, acc0=
                render_waves(k,0,2)) bitwise; gradient run-to-run spread.
7. kernel     — the Pallas triangle search compiled at real widths against
                the XLA form, and the forward image through each.

``--four`` runs final_scene at 1920x1080 sharded over 4 GPUs against 2
GPUs (bitwise) and 1 GPU, cornell_triangle likewise at 512x512, and the
sharded training step of ``__graft_entry__.dryrun_multichip(4)`` against
the same step on 1 GPU.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

# --rehearse-cpu must switch JAX to the CPU before any backend starts
if __name__ == "__main__" and "--rehearse-cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "--four" in sys.argv:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4").strip()

import numpy as np
import jax
import jax.numpy as jnp

from rust_ray_tracer_tpu.models import builders
from rust_ray_tracer_tpu.models.scene import (combine, compile_scene,
                                              partition)
from rust_ray_tracer_tpu.ops import intersect
from rust_ray_tracer_tpu.ops.integrator import render_waves
from rust_ray_tracer_tpu.utils import runtime

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "output", "chip_smoke")

# GPU-vs-CPU budgets per scene: (relative mean error, pixel-flip rate).
# Both sides draw every random number from the same threefry streams, so
# they follow the same sampled paths until a float difference (another
# summation order, another libm) crosses a branch — a hit/miss edge, a
# Fresnel coin, a medium free-flight test — and forks that sample's whole
# path. The budgets only admit such forks. final_scene's media forks
# land on its bright lamp (most flipped pixels are lamp-lit), so its mean
# error is wider and sign-flips across seeds (unbiased); every other
# scene gets (1e-3, 2%). A pixel "flips" when its RGB sum moves > 1e-3.
SCENE_BUDGET = {"final_scene": (2e-2, 0.01)}
DEFAULT_BUDGET = (1e-3, 0.02)
FLIP_EPS = 1e-3

# Kernel-vs-XLA winners: same index on >= 99.9% of rays; where the
# winners differ their t must agree within 1e-5 relative (a tie).
KERNEL_AGREE = 0.999
KERNEL_TIE_RTOL = 1e-5

# 4-GPU vs 1-GPU training-step gradients: max |g4 - g1| per leaf within
# GRAD_RTOL of that leaf's max |g1|. Phase 6 measured the run-to-run
# spread of one GPU's step at 2.3e-7 (the backward's scatter-add atomics);
# across device counts the psum and the per-device chunk sums also
# reassociate, so the bound leaves ~400x that.
GRAD_RTOL = 1e-4

# 4-vs-1 GPU renders of triangle scenes: documented drift class
SHARD_TRI_ATOL, SHARD_TRI_FRAC = 5e-6, 0.03


@dataclasses.dataclass(frozen=True)
class Sizes:
    final_h: int = 1080
    final_aspect: float = 1.7777778      # 1080 * aspect -> 1920
    final_spp: int = 16
    cornell_h: int = 512
    cornell_spp: int = 16
    depth: int = 4
    # mean-radiance bands (lo, hi) of the CLI renders
    final_band: tuple = (0.0, float("inf"))
    cornell_band: tuple = (0.0, float("inf"))
    train_wh: tuple = (512, 288)
    train_spp: int = 4
    train_chunk: int = 9216
    train_steps: int = 5
    cmp_wh: tuple = (128, 72)
    cmp_spp: int = 4
    cmp_chunk: int = 9216
    kernel_rays: int = 9216
    kernel_big_tris: int = 16384
    four_final_spp: int = 4
    four_chunk: int = 32768


# bands: ~+-30% around CPU renders of the same scenes (final_scene 0.208
# at 192x108, cornell_triangle 0.167 at 96x96, 16 spp, two seeds each)
GPU = Sizes(final_band=(0.15, 0.27), cornell_band=(0.12, 0.22))
REHEARSE = Sizes(final_h=18, final_spp=2, cornell_h=16, cornell_spp=2,
                 train_wh=(32, 18), train_spp=1, train_chunk=576,
                 train_steps=2, cmp_wh=(16, 9), cmp_spp=2, cmp_chunk=144,
                 kernel_rays=256, kernel_big_tris=1024, four_final_spp=1,
                 four_chunk=128)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def compare_images(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(relative mean error of a against b, pixel-flip rate)."""
    rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())),
                                                       1e-12)
    flips = float((np.abs(a - b).sum(-1) > FLIP_EPS).mean())
    return rel, flips


def _scene(name: str, aspect: float, **kw):
    if name == "flagship":
        return compile_scene(builders.flagship(aspect, **kw))
    return compile_scene(builders.get_scene(name, aspect))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(rehearse: bool) -> dict:
    rec = runtime.device_record()
    if rehearse:
        if rec["platform"] != "cpu":
            raise RuntimeError(f"--rehearse-cpu found {rec['platform']}")
        log("device", f"CPU rehearsal: {rec['kind']} x {rec['count']}; "
                      "nvidia-smi not queried")
    else:
        rec = runtime.require_gpu()
        log("device", f"{rec['kind']} x {rec['count']}")
        for name, limit in runtime.parse_nvidia_smi(runtime.nvidia_smi()):
            log("device", f"nvidia-smi: {name}, {limit}")
    return rec


def phase_native(sz: Sizes) -> None:
    from rust_ray_tracer_tpu import native
    from rust_ray_tracer_tpu.models.scene import _morton_codes_np

    t0 = time.perf_counter()
    path = native.build(force=True)
    pts = np.random.default_rng(0).uniform(-5, 5, (4096, 3))
    perm = native.morton_sort_native(pts.astype(np.float32))
    ref = np.argsort(_morton_codes_np(pts), kind="stable")
    if not np.array_equal(perm, ref):
        raise RuntimeError("native Morton sort disagrees with NumPy")
    log("native", f"rebuilt {os.path.relpath(path, ROOT)} in "
                  f"{time.perf_counter() - t0:.1f}s; Morton sort == NumPy")


def _cli_render(sz: Sizes, scene: str, height: int, aspect: float,
                spp: int, band: tuple) -> None:
    from rust_ray_tracer_tpu.parallel.checkpoint import load_state
    from rust_ray_tracer_tpu.utils.cli import main as cli_main
    from rust_ray_tracer_tpu.utils.image import decode_png

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"{scene}.png")
    ckpt = png + ".ckpt"
    for f in (png, ckpt):
        if os.path.exists(f):
            os.unlink(f)
    t0 = time.perf_counter()
    rc = cli_main([str(height), str(spp), "--scene", scene, "-a",
                   str(aspect), "-o", png, "--depth", str(sz.depth),
                   "--devices", "1", "--checkpoint", ckpt])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli exit code {rc}")
    width = int(height * aspect)
    img8 = decode_png(open(png, "rb").read())
    if img8.shape != (height, width, 3):
        raise RuntimeError(f"{png}: shape {img8.shape}")
    img = load_state(ckpt).image
    mean = float(img.mean())
    ok = bool(np.isfinite(img).all()) and band[0] <= mean <= band[1]
    log("cli", f"{scene} {width}x{height} {spp}spp depth {sz.depth}: "
               f"wrote {os.path.relpath(png, ROOT)}, finite="
               f"{bool(np.isfinite(img).all())}, mean radiance {mean:.6f} "
               f"(band {band[0]}..{band[1]}), wall {wall:.1f}s incl. "
               "compile")
    if not ok:
        raise RuntimeError(f"{scene}: non-finite pixels or mean outside band")


def phase_cli(sz: Sizes) -> None:
    _cli_render(sz, "final_scene", sz.final_h, sz.final_aspect,
                sz.final_spp, sz.final_band)
    _cli_render(sz, "cornell_triangle", sz.cornell_h, 1.0, sz.cornell_spp,
                sz.cornell_band)


def _train_step_fn(scene, sz: Sizes):
    import optax

    w, h = sz.train_wh
    diff, static = partition(scene)
    opt = optax.adam(1e-2)

    def loss_fn(diff, key):
        img = render_waves(combine(diff, static), w, h, key, 0,
                           sz.train_spp, depth=sz.depth,
                           chunk_size=sz.train_chunk)
        return jnp.mean(img ** 2)

    def step(diff, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(diff, key)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(diff, updates), opt_state, loss, grads

    return diff, opt.init(diff), step


def phase_train(sz: Sizes) -> None:
    scene = _scene("flagship", sz.train_wh[0] / sz.train_wh[1])
    diff, opt_state, step = _train_step_fn(scene, sz)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(diff, opt_state, key).compile()
    log("train", f"step compiled in {time.perf_counter() - t0:.1f}s")
    log("train", f"memory_analysis: {compiled.memory_analysis()}")
    for i in range(sz.train_steps):
        t0 = time.perf_counter()
        diff, opt_state, loss, grads = compiled(
            diff, opt_state, jax.random.fold_in(key, i))
        loss = float(loss)
        dt = time.perf_counter() - t0
        leaves = jax.tree.leaves(grads)
        finite = np.isfinite(loss) and all(
            bool(np.isfinite(np.asarray(g)).all()) for g in leaves)
        g_mat = float(np.abs(np.asarray(grads.tex_color)).max())
        g_vtx = float(np.abs(np.asarray(grads.tri_v0)).max())
        log("train", f"step {i}: loss {loss:.6e}, grads finite={finite}, "
                     f"max|d tex_color| {g_mat:.3e}, max|d tri_v0| "
                     f"{g_vtx:.3e}, {dt * 1e3:.1f} ms")
        if not finite or g_mat == 0.0 or g_vtx == 0.0:
            raise RuntimeError(f"step {i}: non-finite or zero gradients")


def _render_fn(sz: Sizes, wh: tuple, spp: int):
    w, h = wh
    return jax.jit(lambda s, k: render_waves(
        s, w, h, k, 0, spp, depth=sz.depth, chunk_size=sz.cmp_chunk) / spp)


def phase_vs_cpu(sz: Sizes) -> None:
    cpu = jax.devices("cpu")[0]
    key = jax.random.PRNGKey(0)
    failed = []
    for name in ("cornell_triangle", "final_scene"):
        scene = _scene(name, sz.cmp_wh[0] / sz.cmp_wh[1])
        fn = _render_fn(sz, sz.cmp_wh, sz.cmp_spp)
        t0 = time.perf_counter()
        img = np.asarray(fn(scene, key))
        t_dev = time.perf_counter() - t0
        with jax.default_device(cpu):
            ref = np.asarray(_render_fn(sz, sz.cmp_wh, sz.cmp_spp)(
                jax.device_put(scene, cpu), jax.device_put(key, cpu)))
        rel, flips = compare_images(img, ref)
        mean_tol, flip_tol = SCENE_BUDGET.get(name, DEFAULT_BUDGET)
        ok = (bool(np.isfinite(img).all()) and rel < mean_tol
              and flips < flip_tol)
        log("vs_cpu", f"{name} {sz.cmp_wh[0]}x{sz.cmp_wh[1]} {sz.cmp_spp}spp:"
                      f" rel mean err {rel:.3e} (budget {mean_tol:g}), "
                      f"pixel flips {flips:.4%} (budget {flip_tol:.0%}), "
                      f"{jax.devices()[0].platform} call {t_dev:.1f}s "
                      f"incl. compile -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"outside budget: {failed}")


def phase_resume(sz: Sizes) -> None:
    w, h = sz.cmp_wh
    key = jax.random.PRNGKey(3)

    def seg(n):
        return jax.jit(lambda s, acc, start: render_waves(
            s, w, h, key, start, n, depth=sz.depth,
            chunk_size=sz.cmp_chunk, acc0=acc))

    zero = jnp.zeros((h, w, 3), jnp.float32)
    for name in ("flagship", "final_scene"):
        scene = _scene(name, w / h)
        mono = np.asarray(seg(4)(scene, zero, 0))
        part = seg(2)(scene, zero, 0)
        resumed = np.asarray(seg(2)(scene, part, 2))
        bitwise = bool(np.array_equal(mono, resumed))
        log("resume", f"{name}: 4 waves == 2+2 resumed bitwise: {bitwise}")
        if not bitwise:
            raise RuntimeError(f"{name}: resume is not bitwise "
                               f"(max |diff| {np.abs(mono - resumed).max()})")

    # gradient run-to-run spread: the backward scatter-adds with atomics
    # on the GPU, so the same step may differ in the last bits
    scene = _scene("flagship", sz.train_wh[0] / sz.train_wh[1])
    diff, opt_state, step = _train_step_fn(scene, sz)
    fn = jax.jit(step)
    g1 = fn(diff, opt_state, key)[3]
    g2 = fn(diff, opt_state, key)[3]
    worst = 0.0
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        a, b = np.asarray(a), np.asarray(b)
        if a.size:
            worst = max(worst, float(np.abs(a - b).max())
                        / max(float(np.abs(a).max()), 1e-30))
    log("resume", f"train-step gradients, same inputs twice: max |g1-g2| "
                  f"/ max |g1| over leaves = {worst:.3e}")


def _kernel_rays(scene, wh: tuple, n: int, key):
    """``n`` primary rays of a wh frame plus ``n`` incoherent rays (random
    origins in the scene's triangle bounds, random directions)."""
    from rust_ray_tracer_tpu.ops import camera as cam_ops

    o1, d1, _, _ = cam_ops.camera_rays_for_chunk(
        scene.camera, key, 0, n, wh[0], wh[1])
    k1, k2 = jax.random.split(key)
    lo = jnp.min(scene.tri_cluster_min, axis=0)
    hi = jnp.max(scene.tri_cluster_max, axis=0)
    o2 = lo + (hi - lo) * jax.random.uniform(k1, (n, 3))
    d2 = jax.random.normal(k2, (n, 3))
    o = jnp.concatenate([o1, o2])
    d = jnp.concatenate([d1, d2])
    t_max = jnp.where(jnp.arange(2 * n) % 5 == 0, -1.0, jnp.inf)
    return o, d, jnp.full((2 * n,), intersect.T_MIN), t_max


def search_pair(scene, interpret: bool = False):
    """(xla, kernel) jitted triangle searches over ``scene``'s tables."""
    from rust_ray_tracer_tpu.ops import tri_search

    coeffs = intersect._tri_coeffs(scene.tri_v0, scene.tri_e1,
                                   scene.tri_e2)
    xla = jax.jit(lambda o, d, a, b: intersect._tri_search_xla(
        scene, coeffs, o, d, a, b))

    def kern(o, d, a, b):
        tris = tri_search.pack_tris(*coeffs, scene.tri_double)
        return tri_search.search(o, d, a, b, tris, scene.tri_cluster_min,
                                 scene.tri_cluster_max, interpret=interpret)

    return xla, jax.jit(kern)


def agreement(t_x, i_x, t_k, i_k) -> tuple[float, float]:
    """(fraction of rays with the same winner, worst relative t gap where
    the winners differ). A miss on both sides counts as the same."""
    t_x, i_x, t_k, i_k = map(np.asarray, (t_x, i_x, t_k, i_k))
    miss_x, miss_k = ~np.isfinite(t_x), ~np.isfinite(t_k)
    same = (miss_x & miss_k) | (~miss_x & ~miss_k & (i_x == i_k))
    diff = ~same
    if not diff.any():
        return 1.0, 0.0
    gap = np.abs(t_x[diff] - t_k[diff]) / np.maximum(np.abs(t_x[diff]),
                                                     1e-30)
    return float(same.mean()), float(np.nan_to_num(gap, nan=np.inf).max())


class xla_triangle_search:
    """Context: renders traced inside take the XLA triangle search on
    every platform (the A/B reference for the GPU kernel)."""

    def __enter__(self):
        self._saved = intersect._tri_candidates

        def xla(scene, o, d, t_min, t_max):
            coeffs = intersect._tri_coeffs(scene.tri_v0, scene.tri_e1,
                                           scene.tri_e2)
            return intersect._tri_search_xla(scene, coeffs, o, d, t_min,
                                             t_max)
        intersect._tri_candidates = xla
        return self

    def __exit__(self, *exc):
        intersect._tri_candidates = self._saved


def phase_kernel(sz: Sizes, rehearse: bool) -> None:
    key = jax.random.PRNGKey(7)
    cases = [("flagship", dict()),
             ("flagship", dict(n_tris=sz.kernel_big_tris)),
             ("cornell_triangle", dict())]
    failed = []
    for name, kw in cases:
        scene = _scene(name, 16 / 9, **kw)
        o, d, a, b = _kernel_rays(scene, (512, 288), sz.kernel_rays, key)
        xla, kern = search_pair(scene, interpret=rehearse)
        t0 = time.perf_counter()
        kern_c = kern.lower(o, d, a, b).compile()
        t_compile = time.perf_counter() - t0
        same, gap = agreement(*xla(o, d, a, b), *kern_c(o, d, a, b))
        ok = same >= KERNEL_AGREE and gap <= KERNEL_TIE_RTOL
        log("kernel", f"{name} T={scene.n_tris} rays={o.shape[0]}: "
                      f"compiled in {t_compile:.1f}s, same winner "
                      f"{same:.5%}, worst t gap where different {gap:.2e}"
                      f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name}/{scene.n_tris}")

    # forward image: kernel vs XLA search, shared threefry streams
    w, h = sz.cmp_wh
    for name in ("flagship", "cornell_triangle"):
        scene = _scene(name, w / h)
        img_k = np.asarray(_render_fn(sz, sz.cmp_wh, sz.cmp_spp)(scene, key))
        with xla_triangle_search():
            img_x = np.asarray(_render_fn(sz, sz.cmp_wh, sz.cmp_spp)(
                scene, key))
        rel, flips = compare_images(img_k, img_x)
        mean_tol, flip_tol = SCENE_BUDGET.get(name, DEFAULT_BUDGET)
        ok = rel < mean_tol and flips < flip_tol
        log("kernel", f"{name} forward image, kernel vs XLA search: rel "
                      f"mean err {rel:.3e}, pixel flips {flips:.4%} -> "
                      f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name}/image")
    if failed:
        raise RuntimeError(f"kernel disagrees with XLA: {failed}")


def phase_four(sz: Sizes) -> None:
    """The sharded path on 4 devices against 2 and 1."""
    import __graft_entry__ as ge
    from rust_ray_tracer_tpu.parallel.mesh import make_mesh
    from rust_ray_tracer_tpu.parallel.render import (render_waves_sharded,
                                                     replicate_scene)

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, have "
                           f"{len(jax.devices())}")
    key = jax.random.PRNGKey(1)
    failed = []
    for name, hgt, aspect, tri in (
            ("final_scene", sz.final_h, sz.final_aspect, False),
            ("cornell_triangle", sz.cornell_h, 1.0, True)):
        w = int(hgt * aspect)
        scene = _scene(name, aspect)
        imgs = {}
        for n in (4, 2):
            mesh = make_mesh(n_devices=n)
            fn = jax.jit(lambda s, k, mesh=mesh: render_waves_sharded(
                s, w, hgt, k, 0, sz.four_final_spp, mesh, depth=sz.depth,
                chunk_size=sz.four_chunk))
            t0 = time.perf_counter()
            imgs[n] = np.asarray(fn(replicate_scene(scene, mesh), key))
            log("four", f"{name} {w}x{hgt} {sz.four_final_spp}spp on {n} "
                        f"devices: {time.perf_counter() - t0:.1f}s incl. "
                        "compile")
        one = jax.jit(lambda s, k: render_waves(
            s, w, hgt, k, 0, sz.four_final_spp, depth=sz.depth,
            chunk_size=sz.four_chunk))
        imgs[1] = np.asarray(one(jax.device_put(scene, jax.devices()[0]),
                                 key))
        b42 = bool(np.array_equal(imgs[4], imgs[2]))
        dev = np.abs(imgs[4] - imgs[1])
        b41 = bool(np.array_equal(imgs[4], imgs[1]))
        frac = float((dev > SHARD_TRI_ATOL).mean())
        ok41 = b41 or (tri and frac <= SHARD_TRI_FRAC)
        finite = bool(np.isfinite(imgs[4]).all())
        log("four", f"{name}: 4 vs 2 devices bitwise {b42}; 4 vs 1 "
                    f"bitwise {b41} (max |diff| {float(dev.max()):.3e}, "
                    f"{frac:.4%} of values > {SHARD_TRI_ATOL:g}); "
                    f"finite {finite}")
        if not (b42 and ok41 and finite):
            failed.append(name)

    loss4, g4 = ge.dryrun_multichip(4)
    loss1, g1 = ge.sharded_train_step(1)
    worst = 0.0
    for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)):
        a, b = np.asarray(a), np.asarray(b)
        if b.size:
            worst = max(worst, float(np.abs(a - b).max())
                        / max(float(np.abs(b).max()), 1e-30))
    ok = worst <= GRAD_RTOL
    log("four", f"dryrun_multichip(4) train step: loss {float(loss4):.6e} "
                f"vs 1 device {float(loss1):.6e}; max |g4-g1| / max |g1| "
                f"over leaves {worst:.3e} (tolerance {GRAD_RTOL:g}) -> "
                f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("train_step")
    if failed:
        raise RuntimeError(f"sharded path disagrees: {failed}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rehearse-cpu", action="store_true",
                   help="run every phase at tiny sizes on the CPU")
    p.add_argument("--four", action="store_true",
                   help="run only the 4-device sharded path")
    args = p.parse_args(argv)
    sz = REHEARSE if args.rehearse_cpu else GPU

    try:
        device = phase_device(args.rehearse_cpu)
    except (RuntimeError, OSError, ValueError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    cache = runtime.enable_compile_cache()
    log("device", f"compile cache: {cache}")

    if args.four:
        phases = [("four", lambda: phase_four(sz))]
    else:
        phases = [("native", lambda: phase_native(sz)),
                  ("cli", lambda: phase_cli(sz)),
                  ("train", lambda: phase_train(sz)),
                  ("vs_cpu", lambda: phase_vs_cpu(sz)),
                  ("resume", lambda: phase_resume(sz)),
                  ("kernel", lambda: phase_kernel(sz, args.rehearse_cpu))]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:     # reported; the run still exits 1 below
            traceback.print_exc()
            failed.append(name)
        log(name, f"{'FAILED' if name in failed else 'passed'} in "
                  f"{time.perf_counter() - t0:.1f}s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
