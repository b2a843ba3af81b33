"""Device mesh construction (SURVEY.md §5.8).

The engine's two parallel axes:
- ``seq``: data parallelism over independent camera sequences
  (BASELINE config 5: 4 TUM runs in parallel);
- ``pt``: map-block parallelism — landmark blocks + BA edges sharded over
  devices, the reference's "tensor parallel" analog (SURVEY.md §2.3).

Collectives (psum over Schur blocks, all_gather of camera systems) are
emitted by XLA from shard_map code; on GPUs XLA hands them to NCCL.  The
mesh follows the algorithm, not a physical topology: the cards of one host
reach each other all to all over NVLink.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh with axes ('seq', 'pt'); pt gets all devices not used by seq."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if n_devices % seq != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by seq={seq}")
    pt = n_devices // seq
    import numpy as np

    return Mesh(np.array(devices).reshape(seq, pt), ("seq", "pt"))
