"""Multi-device / multi-host parallel rendering.

Replacement for the reference's parallelism layer — rayon row-parallelism
merged through a ``Mutex<RgbImage>`` (reference ``src/main.rs:84-112``).
Here the ray/pixel-chunk axis is sharded over a ``jax.sharding.Mesh`` with
``shard_map``; each device owns its pixel chunks (no mutex, no merging), the
scene is replicated, and parameter gradients are ``psum``-reduced by
shard_map's transpose rule.
"""

from rust_ray_tracer_tpu.parallel.mesh import (  # noqa: F401
    make_mesh, multihost_init)
from rust_ray_tracer_tpu.parallel.render import (  # noqa: F401
    render_image_sharded, render_waves_sharded)
from rust_ray_tracer_tpu.parallel.checkpoint import (  # noqa: F401
    RenderState, load_state, save_state)
