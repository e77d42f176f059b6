"""Device mesh construction and multi-host initialization.

The reference's "cluster init" is a rayon thread-pool sized by ``-t``
(reference ``src/main.rs:44-49``). Here it is a 1-D
``jax.sharding.Mesh`` over the addressable devices in ``jax.devices()``
order (the ``"rays"`` axis — pixel chunks shard over it), plus
``jax.distributed.initialize`` when spanning hosts so every device joins
one mesh. The cards of a host reach each other all to all, so the mesh
follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

RAY_AXIS = "rays"


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Join a multi-process run (``jax.distributed``). A no-op when this
    process already joined; every other failure propagates."""
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the ray axis.

    ``n_devices`` trims to the first N devices (useful for tests and for
    the driver's virtual-device dry run); default is every device jax can
    see (all chips across all hosts in a multi-host run).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))
