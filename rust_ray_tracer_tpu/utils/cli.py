"""Command-line render driver.

Counterpart of the reference binary (``/root/reference/src/main.rs:26-118``
+ ``README.md:11-30``): positional HEIGHT and SAMPLES, ``-o`` output PNG,
``-g`` glTF input, ``-a`` aspect ratio. The reference's ``-t`` threads
(rayon pool size) maps to ``--devices`` (device mesh size, default: all
devices). Its compile-time constants become real flags: ``--depth``
(MAX_DEPTH=4, main.rs:56), ``--scene`` (USE_GLTF=true hardcode, main.rs:67
— procedural scenes were only reachable by editing the source), plus
``--seed`` (the reference is unseeded), and checkpoint/resume flags (no
reference counterpart — it renders one-shot).

Progress is a per-wave line with rays/s and ETA (the reference uses an
indicatif bar per row, main.rs:59-64).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_ray_tracer_tpu",
        description="differentiable wavefront path tracer")
    p.add_argument("height", type=int, nargs="?", default=256,
                   help="image height in pixels (reference positional 1)")
    p.add_argument("samples", type=int, nargs="?", default=16,
                   help="samples per pixel (reference positional 2)")
    p.add_argument("-o", "--output", default="out.png",
                   help="output PNG path")
    p.add_argument("-g", "--gltf", default=None,
                   help="glTF 2.0 scene file")
    p.add_argument("-a", "--aspect", type=float, default=16 / 9,
                   help="aspect ratio (width = height * aspect)")
    p.add_argument("--scene", default=None,
                   help="procedural scene name (cornell_box, random, ...); "
                        "overrides --gltf")
    p.add_argument("--depth", type=int, default=4,
                   help="max bounce depth (reference MAX_DEPTH=4)")
    p.add_argument("--seed", type=int, default=0,
                   help="render seed (bitwise-reproducible)")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices to shard rays over "
                        "(default: all available)")
    p.add_argument("--chunk-size", type=int, default=32768,
                   help="rays per wavefront chunk")
    p.add_argument("--compact", choices=("auto", "on", "off"),
                   nargs="?", const="on", default="auto",
                   help="bounce-major cross-chunk alive compaction: "
                        "'auto' (default) enables it when the scene "
                        "covers most of the camera frame "
                        "(ops/integrator.auto_compact); shard-local "
                        "under a device mesh")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable rendering")
    p.add_argument("--ckpt-every", type=int, default=8,
                   help="checkpoint every N sample waves")
    p.add_argument("--no-flip", action="store_true",
                   help="skip the reference's vertical flip at write time")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address (host:port)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import numpy as np

    from rust_ray_tracer_tpu.models import builders
    from rust_ray_tracer_tpu.models.gltf import load_gltf_scene
    from rust_ray_tracer_tpu.models.scene import compile_scene
    from rust_ray_tracer_tpu.ops.tonemap import tonemap_mean
    from rust_ray_tracer_tpu.parallel import make_mesh, multihost_init
    from rust_ray_tracer_tpu.parallel.checkpoint import (
        render_with_checkpoints)
    from rust_ray_tracer_tpu.utils.image import save_png
    from rust_ray_tracer_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    if args.coordinator or (args.num_processes or 0) > 1:
        multihost_init(args.coordinator, args.num_processes, args.process_id)

    height = args.height
    width = int(height * args.aspect)
    spp = args.samples

    if args.scene:
        host_scene = builders.get_scene(args.scene, args.aspect, args.seed)
    elif args.gltf:
        host_scene = load_gltf_scene(args.gltf, args.aspect)
    else:
        print("error: provide --scene NAME or -g FILE.gltf",
              file=sys.stderr)
        return 2
    scene = compile_scene(host_scene)

    n_dev = args.devices or len(jax.devices())
    mesh = make_mesh(n_devices=n_dev) if n_dev > 1 else None

    if args.compact == "auto":
        from rust_ray_tracer_tpu.ops.integrator import auto_compact
        compact = auto_compact(scene)
        print(f"  compact=auto -> {'on' if compact else 'off'}",
              flush=True)
    else:
        compact = args.compact == "on"

    ckpt = args.checkpoint or (args.output + ".ckpt")
    total_rays = width * height * spp * args.depth
    t0 = time.time()

    def progress(done, total):
        dt = time.time() - t0
        rate = width * height * done * args.depth / max(dt, 1e-9)
        eta = dt / done * (total - done)
        print(f"  wave {done}/{total}  {rate/1e6:.2f} Mrays/s  "
              f"eta {eta:.0f}s", flush=True)

    img = render_with_checkpoints(
        scene, width, height, spp, args.seed, ckpt,
        ckpt_every=args.ckpt_every, depth=args.depth,
        chunk_size=args.chunk_size, mesh=mesh, progress=progress,
        compact=compact)

    if jax.process_index() == 0:
        u8 = np.asarray(tonemap_mean(jax.numpy.asarray(img)))
        save_png(args.output, u8, flip_vertical=not args.no_flip)
        dt = time.time() - t0
        print(f"wrote {args.output} ({width}x{height}, {spp}spp, "
              f"depth {args.depth}, {n_dev} device(s)) in {dt:.1f}s "
              f"— {total_rays/dt/1e6:.2f} Mrays/s")
    # leave the finished checkpoint so a re-run is a no-op restart; the
    # reference has no equivalent (one-shot render)
    return 0


if __name__ == "__main__":
    sys.exit(main())
