"""A/B on one GPU: the Pallas triangle search against XLA's plain form.

    python ab_search.py [search] [wave] [compact] [sweep]
                        [--out output/ab_search.json]

Times, in turns (XLA, kernel, kernel, XLA) on one card:

* the search call alone, on 9216 rays (half primary rays of a 512x288
  frame, half incoherent, a fifth of them dead lanes);
* one full forward wave end to end (render_waves, 512x288, 1 spp,
  depth 4, chunk 9216);

on the flagship mesh (968 triangles), the same generator at 16,384
triangles, and cornell_triangle. ``compact`` times compaction on and off
for final_scene, random, cornell_triangle and the flagship; ``sweep``
times the kernel's block shapes on the search alone; ``profile`` traces
three forward waves of each form and sums device time per operation. Default: search,
wave and compact. Every time is a median over repeated calls that end
in ``block_until_ready``; compile time is excluded and reported. Refuses
to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import jax

import chip_smoke as cs
from rust_ray_tracer_tpu.ops import tri_search
from rust_ray_tracer_tpu.ops.integrator import render_waves
from rust_ray_tracer_tpu.utils import runtime

W, H, CHUNK, DEPTH = 512, 288, 9216, 4
# (BLOCK_RAYS, BLOCK_TRIS, NUM_WARPS, NUM_STAGES, TARGET_PROGRAMS)
SWEEP = ((64, 32, 4, 2, 1024), (64, 32, 4, 2, 1), (32, 32, 4, 2, 1024),
         (128, 32, 4, 2, 1024), (64, 16, 4, 2, 1024), (64, 64, 4, 2, 1024),
         (64, 32, 2, 2, 1024), (64, 32, 8, 2, 1024), (64, 32, 4, 1, 1024),
         (64, 32, 4, 3, 1024), (64, 32, 4, 2, 4096), (32, 32, 2, 2, 2048),
         (32, 16, 2, 2, 4096), (128, 16, 4, 2, 1024))


def median_ms(fn, args, reps: int) -> float:
    jax.block_until_ready(fn(*args))                 # warm (compiled)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def turns(fx, fk, args, reps: int) -> dict:
    """XLA, kernel, kernel, XLA — medians of each side's two turns."""
    x1 = median_ms(fx, args, reps)
    k1 = median_ms(fk, args, reps)
    k2 = median_ms(fk, args, reps)
    x2 = median_ms(fx, args, reps)
    return {"xla_ms": [x1, x2], "kernel_ms": [k1, k2],
            "speedup": statistics.mean([x1, x2]) / statistics.mean([k1, k2])}


def device_profile(fn, args, trace_dir: str, waves: int = 3) -> dict:
    """Trace ``waves`` calls; per device plane: busy share of the traced
    window and the top operations by device time per call."""
    import glob

    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(waves):
            jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        ops = lines.get("XLA Ops") or [e for k, v in lines.items()
                                       if k != "XLA Modules" for e in v]
        if not ops:
            continue
        per = {}
        for e in ops:
            per[e.name] = per.get(e.name, 0) + e.duration_ns
        iv = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in ops)
        busy, end = 0, None
        for a, b in iv:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        window = iv[-1][1] - iv[0][0]
        top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
        out[plane.name] = {
            "lines": sorted(lines), "busy_ms_per_call": busy / waves / 1e6,
            "window_ms_per_call": window / waves / 1e6,
            "top_ms_per_call": [[k, v / waves / 1e6] for k, v in top]}
    return out


def scenes():
    return [("flagship_968", cs._scene("flagship", W / H)),
            ("flagship_16384", cs._scene("flagship", W / H, n_tris=16384)),
            ("cornell_triangle", cs._scene("cornell_triangle", W / H))]


def wave_fns(scene, compact=False):
    key = jax.random.PRNGKey(0)

    def make():
        return jax.jit(lambda s: render_waves(s, W, H, key, 0, 1,
                                              depth=DEPTH, chunk_size=CHUNK,
                                              compact=compact))
    fk = make()
    with cs.xla_triangle_search():
        fx = make()
        t0 = time.perf_counter()
        jax.block_until_ready(fx(scene))             # trace under the patch
        tcx = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fk(scene))
    tck = time.perf_counter() - t0
    return fx, fk, tcx, tck


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("sections", nargs="*",
                   default=["search", "wave", "compact"],
                   choices=["search", "wave", "compact", "sweep",
                            "profile"])
    p.add_argument("--out", default=os.path.join("output",
                                                 "ab_search.json"))
    args = p.parse_args()
    device = runtime.require_gpu()
    runtime.enable_compile_cache()
    smi = runtime.parse_nvidia_smi(runtime.nvidia_smi())
    print("device", device, "nvidia-smi", smi, flush=True)
    res = {"device": device, "nvidia_smi": smi,
           "config": dict(block_rays=tri_search.BLOCK_RAYS,
                          block_tris=tri_search.BLOCK_TRIS,
                          num_warps=tri_search.NUM_WARPS,
                          num_stages=tri_search.NUM_STAGES,
                          target_programs=tri_search.TARGET_PROGRAMS),
           "search": {}, "wave": {}, "sweep": {}, "compact": {},
           "profile": {}}
    key = jax.random.PRNGKey(7)
    knobs = ("BLOCK_RAYS", "BLOCK_TRIS", "NUM_WARPS", "NUM_STAGES",
             "TARGET_PROGRAMS")
    for name, scene in scenes():
        if "search" in args.sections:
            o, d, a, b = cs._kernel_rays(scene, (W, H), CHUNK // 2, key)
            fx, fk = cs.search_pair(scene)
            same, gap = cs.agreement(*fx(o, d, a, b), *fk(o, d, a, b))
            r = turns(fx, fk, (o, d, a, b), 20)
            r.update(same_winner=same, worst_tie_gap=gap,
                     n_tris=scene.n_tris)
            res["search"][name] = r
            print("search", name, json.dumps(r), flush=True)
        if "wave" not in args.sections:
            continue
        fx, fk, tcx, tck = wave_fns(scene)
        r = turns(fx, fk, (scene,), 10)
        r.update(compile_s_xla=tcx, compile_s_kernel=tck)
        res["wave"][name] = r
        print("wave", name, json.dumps(r), flush=True)

    if "profile" in args.sections:
        for name, scene in scenes():
            fx, fk, _, _ = wave_fns(scene)
            for form, fn in (("xla", fx), ("kernel", fk)):
                r = device_profile(fn, (scene,), f"output/prof/{name}_{form}")
                res["profile"][f"{name}/{form}"] = r
                print("profile", name, form, json.dumps(r), flush=True)

    if "sweep" in args.sections:
        saved = tuple(getattr(tri_search, k) for k in knobs)
        for name, scene in scenes():
            o, d, a, b = cs._kernel_rays(scene, (W, H), CHUNK // 2, key)
            for cfg in SWEEP:
                for k, v in zip(knobs, cfg):
                    setattr(tri_search, k, v)
                _, fk = cs.search_pair(scene)
                ms = median_ms(fk, (o, d, a, b), 20)
                res["sweep"].setdefault(name, []).append([*cfg, ms])
                print("sweep", name, cfg, f"{ms:.4f} ms", flush=True)
        for k, v in zip(knobs, saved):
            setattr(tri_search, k, v)

    if "compact" in args.sections:
        key0 = jax.random.PRNGKey(0)
        for name in ("final_scene", "random", "cornell_triangle",
                     "flagship"):
            scene = cs._scene(name, W / H)
            fns = {c: jax.jit(lambda s, c=c: render_waves(
                s, W, H, key0, 0, 1, depth=DEPTH, chunk_size=CHUNK,
                compact=c)) for c in (False, True)}
            off1 = median_ms(fns[False], (scene,), 5)
            on1 = median_ms(fns[True], (scene,), 5)
            on2 = median_ms(fns[True], (scene,), 5)
            off2 = median_ms(fns[False], (scene,), 5)
            res["compact"][name] = {"off_ms": [off1, off2],
                                    "on_ms": [on1, on2]}
            print("compact", name, json.dumps(res["compact"][name]),
                  flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
