"""Bring-up helpers (counterpart: ``accl_tpu/utils/bringup.py``); only
:func:`detect_backend` is ported so far."""
from __future__ import annotations

import torch

from ..config import TransportBackend


def detect_backend(device) -> TransportBackend:
    """Classify the transport from the ranks' device: CUDA ranks talk over
    the intra-node tier (``ICI``), CPU ranks are emulated (``SIM``)."""
    return (TransportBackend.ICI if torch.device(device).type == "cuda"
            else TransportBackend.SIM)
