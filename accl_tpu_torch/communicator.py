"""Communicator: the rank group (counterpart: ``accl_tpu/communicator.py``).

The JAX package orders its ranks on a device mesh axis, one device per
rank. Here a rank is a slot ``r`` of a ``(world_size, n)`` tensor on one
``torch.device``: on the card every rank is a row of device memory, which
the ring kernels reach through a per-rank pointer table, so the same
kernels can later be pointed at peer-mapped cards. ``split`` (sub-groups),
the per-rank table and the two-sided sequence state come with later slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class Communicator:
    """``world_size`` ranks on ``device``."""

    def __init__(self, world_size: int, device):
        if world_size < 1:
            raise ValueError("communicator needs at least one rank")
        self.world_size = int(world_size)
        self.device = torch.device(device)

    def hosts_shape(self) -> Optional[Tuple[int, int]]:
        """(hosts, ranks per host) on a multi-host group. Ranks on one card
        have no host boundary, so this is None: AUTO never engages the
        host-aligned paths, an explicit HIERARCHICAL request on DCN is
        refused, and an explicit TWOTIER request takes the most-square
        ``factor2d`` split, as the JAX package does on a single-host mesh
        (its bench A/B control)."""
        return None
