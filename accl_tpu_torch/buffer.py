"""Device buffer (counterpart: ``accl_tpu/buffer.py``).

A ``Buffer`` owns a ``(world, count)`` tensor on the communicator's device,
row ``r`` being rank ``r``'s memory, plus a ``host`` numpy mirror with
``sync_to_device``/``sync_from_device`` bounce semantics. Both sides are
allocated on first access: the host mirror when the host is first touched
(zeros, or ``host_data``), the device tensor when a collective first reads
it (uploaded from the host mirror, zeros if there is none). So a run that
keeps its payload on the card (``from_device``/``to_device``) never holds a
host copy: a 1 GiB-per-rank buffer at world 8 needs 8 GiB on the card and
nothing on the host. bf16 buffers mirror on the host as float32, which
holds every bf16 value exactly; ``sync_to_device`` rounds to nearest even.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import constants
from .communicator import Communicator
from .constants import dataType


class Buffer:
    def __init__(self, count: int, dtype: dataType, comm: Communicator,
                 host_data: Optional[np.ndarray] = None):
        self.count = int(count)
        self.dtype = dataType(dtype)
        self.comm = comm
        self._host: Optional[np.ndarray] = None
        self._device: Optional[torch.Tensor] = None
        if host_data is not None:
            host_data = np.asarray(host_data, dtype=self.np_dtype)
            if host_data.shape != (comm.world_size, self.count):
                raise ValueError(
                    f"host data shape {host_data.shape} != "
                    f"({comm.world_size}, {self.count})")
            self._host = np.array(host_data)

    @property
    def torch_dtype(self) -> torch.dtype:
        return constants.to_torch_dtype(self.dtype)

    @property
    def np_dtype(self):
        return constants.to_numpy_dtype(self.dtype)

    # ---- host mirror ------------------------------------------------------

    @property
    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = np.zeros((self.comm.world_size, self.count),
                                  dtype=self.np_dtype)
        return self._host

    def sync_to_device(self) -> None:
        """Host mirror -> device rows (a copy: later host writes never reach
        data already on the device)."""
        src = torch.from_numpy(np.array(self.host))
        self._device = src.to(device=self.comm.device, dtype=self.torch_dtype)

    def sync_from_device(self) -> None:
        """Device rows -> host mirror."""
        if self._device is None:
            return
        t = self._device
        if t.dtype == torch.bfloat16:
            t = t.float()
        self._host = t.cpu().numpy().astype(self.np_dtype, copy=False)

    # ---- device access ----------------------------------------------------

    @property
    def data(self) -> torch.Tensor:
        """The ``(world, count)`` device tensor, materialized on demand."""
        if self._device is None:
            if self._host is not None:
                self.sync_to_device()
            else:
                self._device = torch.zeros(
                    (self.comm.world_size, self.count),
                    dtype=self.torch_dtype, device=self.comm.device)
        return self._device

    def device_store(self, value: torch.Tensor) -> None:
        """Make ``value`` (world, count) this buffer's device data."""
        if tuple(value.shape) != (self.comm.world_size, self.count):
            raise ValueError(f"device value shape {tuple(value.shape)} != "
                             f"({self.comm.world_size}, {self.count})")
        self._device = value.to(device=self.comm.device,
                                dtype=self.torch_dtype)
