"""Tensor- and data-parallel MLP block (counterpart:
``accl_tpu/models/mlp.py``), forward only.

A Megatron-style block, ``gelu(x @ W1 + b1) @ W2 + b2`` with the tanh GELU
(``jax.nn.gelu``'s default), over a (dp, tp) split of the world: rank
``dp_i * tp + tp_j`` holds column block ``tp_j`` of W1 and b1, row block
``tp_j`` of W2, all of b2, and a copy of dp group ``dp_i``'s rows of x.
Layout, every rank a row of the first axis:

  w1 (world, d, h/tp), b1 (world, h/tp), w2 (world, h/tp, d), b2 (world, d)
  x  (world, rows, d): each rank's copy of its dp group's rows

Two tensor-parallel datapaths, the same math:

* the psum baseline: the local matmuls, then the row-parallel sum over the
  tp ranks of a dp group;
* the fused datapath: the column-parallel matmul as
  :func:`..device_api.all_gather_matmul` over the rows' tp shards and the
  row-parallel combine as :func:`..device_api.matmul_reduce_scatter`,
  then the all-gather of the scattered rows. It runs only when both fused
  kernels engage (``cm.agmm_engages`` and ``cm.mmrs_engages``), as in the
  JAX package; otherwise the baseline runs.

Training (``make_train_step``) waits for ROADMAP.md queue 1, item 10b.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_api as dapi
from ..communicator import Communicator
from ..constants import ACCLError, errorCode
from ..ops import collective_matmul as cm


class MLPParams(NamedTuple):
    w1: torch.Tensor  # (d, h); sharded: (world, d, h/tp)
    b1: torch.Tensor  # (h,); sharded: (world, h/tp)
    w2: torch.Tensor  # (h, d); sharded: (world, h/tp, d)
    b2: torch.Tensor  # (d,); sharded: (world, d)


def init_params(gen: torch.Generator, d_model: int,
                d_hidden: int) -> MLPParams:
    """Random dense parameters from ``gen`` (on the generator's device),
    scaled as the JAX package scales them: w1 sqrt(2/d_model), w2
    sqrt(2/d_hidden), zero biases."""
    dev = gen.device
    return MLPParams(
        w1=torch.randn((d_model, d_hidden), generator=gen, device=dev)
        * (2.0 / d_model) ** 0.5,
        b1=torch.zeros((d_hidden,), device=dev),
        w2=torch.randn((d_hidden, d_model), generator=gen, device=dev)
        * (2.0 / d_hidden) ** 0.5,
        b2=torch.zeros((d_model,), device=dev))


def apply(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """The dense single-device forward of unsharded parameters, f32
    accumulation."""
    h = torch.matmul(x.float(), p.w1.float()) + p.b1
    return torch.matmul(F.gelu(h, approximate="tanh"), p.w2.float()) + p.b2


def shard_params(params: MLPParams, comm: Communicator, dp: int,
                 tp: int) -> MLPParams:
    """Dense parameters -> each rank's column and row shards on the
    communicator's device (rank ``dp_i * tp + tp_j`` takes block
    ``tp_j``)."""
    if dp * tp != comm.world_size:
        raise ValueError(f"dp {dp} x tp {tp} != world {comm.world_size}")
    d, h = params.w1.shape
    if h % tp:
        raise ValueError(f"d_hidden {h} not divisible by tp {tp}")
    hl = h // tp

    def per_rank(t):
        return t.unsqueeze(0).expand(dp, *t.shape).reshape(
            comm.world_size, *t.shape[1:]).to(comm.device).contiguous()

    return MLPParams(
        w1=per_rank(params.w1.reshape(d, tp, hl).transpose(0, 1)),
        b1=per_rank(params.b1.reshape(tp, hl)),
        w2=per_rank(params.w2.reshape(tp, hl, d)),
        b2=params.b2.to(comm.device).unsqueeze(0).expand(
            comm.world_size, d).contiguous())


def params_from_jax(params, comm: Communicator, dp: int,
                    tp: int) -> MLPParams:
    """Carry a JAX ``MLPParams`` (or any four arrays numpy can read) into the
    port as per-rank shards (:func:`shard_params`)."""
    dense = MLPParams(*(torch.from_numpy(np.array(t, copy=True))
                        for t in (params.w1, params.b1, params.w2,
                                  params.b2)))
    return shard_params(dense, comm, dp, tp)


def _forward_local(p: MLPParams, x: torch.Tensor, tp: int,
                   overlap: Optional[bool] = False,
                   wire_dtype=None) -> torch.Tensor:
    """Every rank's forward: x (world, rows, d) -> (world, rows, d) f32.
    ``overlap`` picks the datapath (None: the session default and size
    registers; True forces the fused kernels at any size); ``wire_dtype``
    stages the fused rings' payloads compressed."""
    world, rows, d = x.shape
    dp = world // tp
    h_loc = p.w1.shape[2]
    if (tp > 1 and rows % tp == 0
            and cm.agmm_engages(rows // tp, d, h_loc, tp, x.dtype, overlap,
                                wire_dtype=wire_dtype, w_dtype=p.w1.dtype)
            and cm.mmrs_engages(rows, h_loc, p.w2.shape[2], tp, x.dtype,
                                overlap, wire_dtype=wire_dtype,
                                w_dtype=p.w2.dtype)):
        # rank (i, j) keeps row block j of its group's rows; the fused
        # column-parallel matmul regenerates all rows hop by hop
        ms = rows // tp
        diag = torch.arange(tp, device=x.device)
        x_s = x.view(dp, tp, tp, ms, d)[:, diag, diag].reshape(world, ms, d)
        ys = []
        for g in range(dp):
            grp = slice(g * tp, (g + 1) * tp)
            h = dapi.all_gather_matmul(x_s[grp], p.w1[grp], overlap=overlap,
                                       wire_dtype=wire_dtype)
            h = F.gelu(h + p.b1[grp, None, :], approximate="tanh")
            ys.append(dapi.matmul_reduce_scatter(h.to(x.dtype), p.w2[grp],
                                                 overlap=overlap,
                                                 wire_dtype=wire_dtype))
        # the all-gather of the scattered rows: all_gather(psum_scatter(p))
        # == psum(p)
        y = torch.stack(ys).view(dp, 1, rows, d).expand(dp, tp, rows, d)
        return y.reshape(world, rows, d) + p.b2[:, None, :]
    h = torch.matmul(x.float(), p.w1.float()) + p.b1[:, None, :]
    h = F.gelu(h, approximate="tanh")
    y_partial = torch.matmul(h, p.w2.float())
    y = y_partial.view(dp, tp, rows, d).sum(1, keepdim=True)
    return y.expand(dp, tp, rows, d).reshape(world, rows, d) \
        + p.b2[:, None, :]


def make_forward(comm: Communicator, dp: int, tp: int,
                 overlap: Optional[bool] = None, wire_dtype=None):
    """The forward over a (dp, tp) split of the world: ``fwd(params, x)``
    with ``params`` from :func:`shard_params` and x (N, d), N divisible by
    dp, dp group i taking rows i*N/dp..; returns (N, d) f32. ``overlap``
    picks the datapath (None: the session default), ``wire_dtype`` the
    fused rings' wire staging."""
    world = comm.world_size
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world {world}")

    def fwd(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
        N, d = x.shape
        if N % dp:
            raise ValueError(f"rows {N} not divisible by dp {dp}")
        rows = N // dp
        xr = x.view(dp, 1, rows, d).expand(dp, tp, rows, d) \
            .reshape(world, rows, d)
        y = _forward_local(params, xr, tp, overlap=overlap,
                           wire_dtype=wire_dtype)
        return y.view(dp, tp, rows, d)[:, 0].reshape(N, d)

    return fwd


def make_train_step(*args, **kwargs):
    """Not ported yet: the backward needs the collective matmuls' duals and
    the gathered-wgrad kernel (ROADMAP.md queue 1, item 10b)."""
    raise ACCLError(errorCode.COLLECTIVE_NOT_IMPLEMENTED,
                    "mlp.make_train_step is not ported yet (ROADMAP.md "
                    "queue 1, item 10b)")
