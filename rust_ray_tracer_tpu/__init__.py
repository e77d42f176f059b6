"""rust_ray_tracer_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX reimplementation of the capabilities of the
Safarte/rust-ray-tracer reference (a Shirley-style CPU path tracer in Rust),
re-designed for data-parallel accelerators:

  * structure-of-arrays scene data (no pointer trees),
  * ray/triangle intersection expressed as linear functions of Plücker ray
    features (one ``[N,10] @ [10,4T]`` contraction, or on the GPU one
    fused Pallas kernel, replaces per-ray Möller–Trumbore recursion),
  * an iterative wavefront integrator (fixed bounce depth, branchless
    material evaluation) replacing the reference's per-pixel recursion
    (``/root/reference/src/ray.rs:78-127``),
  * counter-based ``jax.random`` keys for bitwise-reproducible renders under
    any device sharding (the reference uses unseeded ``thread_rng``),
  * differentiable end-to-end (material / camera / vertex gradients) via
    detached sampling,
  * multi-device scaling by sharding the ray axis over a
    ``jax.sharding.Mesh``.

Package layout:
  ops/       compute kernels: camera ray-gen, intersection, shading,
             sampling, textures, tonemap, the wavefront integrator
  models/    scene representation (SoA), procedural scene library, glTF import
  parallel/  device meshes, sharded rendering, checkpoint/resume
  utils/     RNG discipline, PNG image IO, CLI driver, logging
"""

__version__ = "0.1.0"

from rust_ray_tracer_tpu.models.scene import SceneData, compile_scene  # noqa: F401
from rust_ray_tracer_tpu.ops.integrator import render_image, trace_rays  # noqa: F401
