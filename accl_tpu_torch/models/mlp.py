"""Tensor- and data-parallel MLP block (counterpart:
``accl_tpu/models/mlp.py``): its forward and its SGD train step.

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

The backward of the fused datapath runs the collective matmuls' duals and
the gathered-wgrad kernel (:mod:`..ops.collective_matmul`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_api as dapi
from ..communicator import Communicator
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


def make_loss_and_grads(comm: Communicator, dp: int, tp: int,
                        overlap: Optional[bool] = None, wire_dtype=None):
    """The gradient half of :func:`make_train_step`: ``fn(params, x,
    targets) -> (loss, grads)`` with ``params`` from :func:`shard_params`,
    x and targets (N, d), dp group i taking rows i*N/dp..; returns the dp
    mean of the MSE loss (a 0-d tensor) and the dp-mean gradients in the
    sharded layout.

    Every rank holds its own loss, ``mean((y - t)^2)`` over its group's
    rows, and the backward runs on their sum, as ``jax.value_and_grad``
    inside the JAX package's ``shard_map`` does: the tp ranks of a group
    hold the same loss, so the row-parallel sum's backward (and the fused
    path's gather of the scattered rows) adds their tp identical
    cotangents, and the gradients of w1, b1 and w2 are tp times the dense
    gradient, b2's once."""
    world = comm.world_size
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world {world}")

    def fn(params: MLPParams, x: torch.Tensor, targets: torch.Tensor):
        N, d = x.shape
        if N % dp:
            raise ValueError(f"rows {N} not divisible by dp {dp}")
        rows = N // dp

        def per_rank(t):
            return t.view(dp, 1, rows, d).expand(dp, tp, rows, d) \
                .reshape(world, rows, d)

        with torch.enable_grad():
            p = MLPParams(*(t.detach().requires_grad_() for t in params))
            y = _forward_local(p, per_rank(x), tp, overlap=overlap,
                               wire_dtype=wire_dtype)
            losses = ((y - per_rank(targets)) ** 2).mean(dim=(1, 2))
            losses.sum().backward()
        # the dp gradient mean: the sum over the dp rows of each tp column
        grads = MLPParams(*(
            (t.grad.view(dp, tp, *t.shape[1:]).sum(0) / dp).unsqueeze(0)
            .expand(dp, tp, *t.shape[1:]).reshape(t.shape) for t in p))
        loss = losses.detach().view(dp, tp)[:, 0].sum() / dp
        return loss, grads

    return fn


def make_train_step(comm: Communicator, dp: int, tp: int, lr: float = 1e-2,
                    overlap: Optional[bool] = None, wire_dtype=None):
    """One SGD step over a (dp, tp) split of the world: ``step(params, x,
    targets) -> (new_params, loss)``, params as :func:`shard_params` lays
    them out, the loss before the step (the dp mean). Forward, backward,
    the dp gradient mean and the update as the JAX ``make_train_step``
    (:func:`make_loss_and_grads` has the gradient scaling). ``overlap``
    picks the tensor-parallel datapath of both passes (None: the session
    default), ``wire_dtype`` the fused rings' wire staging."""
    loss_and_grads = make_loss_and_grads(comm, dp, tp, overlap=overlap,
                                         wire_dtype=wire_dtype)

    def step(params: MLPParams, x: torch.Tensor, targets: torch.Tensor):
        loss, grads = loss_and_grads(params, x, targets)
        return MLPParams(*(w.detach() - lr * g
                           for w, g in zip(params, grads))), loss

    return step
