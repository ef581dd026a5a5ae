"""Device-mesh construction and multi-host bring-up."""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host job bring-up (jax.distributed). No-op when single-process
    (the common dev/test case); in a multi-host job each host calls this before
    building the mesh, mirroring the reference's (absent) cluster layer —
    SURVEY.md section 7 'Distributed communication backend'."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(pixel_tiles: int = 0, map_blocks: int = 0,
              devices=None) -> Mesh:
    """Mesh with axes ('pixel_tile', 'map_block').

    Defaults: use every available device on the pixel_tile axis. The
    product must equal the device count (devices are reshaped in order,
    pixel_tile fastest; every GPU of a host reaches every other at the
    same rate, so the layout follows the algorithm alone).
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    n = devices.size
    if pixel_tiles <= 0 and map_blocks <= 0:
        pixel_tiles, map_blocks = n, 1
    elif pixel_tiles <= 0:
        pixel_tiles = n // map_blocks
    elif map_blocks <= 0:
        map_blocks = n // pixel_tiles
    assert pixel_tiles * map_blocks == n, (pixel_tiles, map_blocks, n)
    return Mesh(devices.reshape(map_blocks, pixel_tiles),
                ("map_block", "pixel_tile"))
