"""ZeRO-style fully-sharded data parallelism, the per-layer block bodies
(counterpart: ``accl_tpu/models/zero.py``).

Ported so far: what one transformer block per pipeline stage runs
(:mod:`.pipeline`'s composed step): the geometry helpers
(:func:`_attn_sizes`, :func:`_validate_geometry`), the engage policy of
the fused datapath (:func:`fsdp_engage_reason`), the bucket gather whose
gradient is the wire-staged reduce-scatter (:func:`_bucket_gather`), and the
block math (:func:`_attention`, :func:`_attn_sublayer`,
:func:`_mlp_sublayer`). The flat ZeRO step, the layerwise FSDP step, buddy
replicas and ``restore_zero_state`` come with ROADMAP.md queue 1, item 12.

Shapes. The JAX bodies run per device inside a ``shard_map``; here every
rank is a slot of leading axes. The block math takes activations (G, tp, b,
d): G independent groups (stages x dp ranks) of tp ranks, each rank's own
copy of its group's b rows. Megatron's tp ``psum`` is the sum over the tp
axis, handed back to every tp rank, whose backward adds the tp ranks'
cotangents, as the ``psum`` transpose does in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import collective_matmul as cm


def _attn_sizes(d_model: int, tp: int) -> Tuple[int, int]:
    """(dtp, n_attn): per-tp-rank attention column width d/tp and the
    unpadded flat bucket length 4·d·dtp (Wqkv (d, 3·dtp) + Wo (dtp, d)),
    the pipeline stack's bucket layout."""
    dtp = d_model // tp
    return dtp, 4 * d_model * dtp


def _validate_geometry(dp: int, tp: int, d_model: int, d_hidden: int,
                       n_heads: int) -> None:
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} % n_heads {n_heads} != 0")
    if n_heads % tp or d_model % tp or d_hidden % tp:
        raise ValueError(
            f"tp {tp} must divide n_heads {n_heads}, d_model {d_model} "
            f"and d_hidden {d_hidden}")
    if (d_hidden // tp) % dp or d_model % dp:
        raise ValueError(
            f"dp {dp} must divide the tp-local hidden {d_hidden // tp} "
            f"and d_model {d_model} (the ZeRO column shards)")


# ---------------------------------------------------------------------------
# engage policy: commit to the fused datapath only when every per-layer
# kernel plan engages
# ---------------------------------------------------------------------------

def fsdp_engage_reason(d_model: int, d_hidden: int, batch: int,
                       dp: int, tp: int,
                       overlap: Optional[bool] = None,
                       bidirectional: bool = True,
                       wire_dtype=None) -> Optional[str]:
    """None when the fused datapath would run for this geometry: both
    forward all-gather x matmuls (w1, w2 travel shards against the (k,
    batch) activation panel), both dual matmul x reduce-scatter gradient
    reductions and both gathered-wgrad activation gradients resolve to the
    kernels. Otherwise the first decline reason, in the
    ``accl_cmatmul_fallback_total`` vocabulary. ``batch`` is the per-dp-rank
    row count."""
    h_tp = d_hidden // tp
    f32 = torch.float32
    checks = (
        lambda: cm.agmm_engage_reason(
            h_tp // dp, d_model, batch, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, w_dtype=f32),
        lambda: cm.agmm_engage_reason(
            d_model // dp, h_tp, batch, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, w_dtype=f32),
        lambda: cm.mmrs_engage_reason(
            h_tp, batch, d_model, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, w_dtype=f32),
        lambda: cm.mmrs_engage_reason(
            d_model, batch, h_tp, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, w_dtype=f32),
        lambda: cm.wgrad_engage_reason(
            h_tp // dp, d_model, batch, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, loc_dtype=f32),
        lambda: cm.wgrad_engage_reason(
            d_model // dp, h_tp, batch, dp, f32, overlap, bidirectional,
            wire_dtype=wire_dtype, loc_dtype=f32),
    )
    for check in checks:
        reason = check()
        if reason is not None:
            return reason
    return None


# ---------------------------------------------------------------------------
# the bucket gather: the all-gather whose gradient is the wire-staged
# reduce-scatter
# ---------------------------------------------------------------------------

class _BucketGather(torch.autograd.Function):
    """Forward: shards (..., dp, n) -> (..., dp, dp*n), every dp rank the
    concatenation. Backward: each rank's cotangent rounded once to the wire
    dtype, summed over the dp ranks in rank order (a bf16 wire accumulates
    in f32 and rounds once, as XLA's CPU reduction does), rank i keeping
    block i (``lax.psum_scatter``)."""

    @staticmethod
    def forward(ctx, shard, wire_dtype):
        ctx.wire_dtype = wire_dtype
        dp, n = shard.shape[-2], shard.shape[-1]
        full = shard.reshape(*shard.shape[:-2], dp * n)
        return full.unsqueeze(-2).expand(*shard.shape[:-2], dp, dp * n) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        dp, full = g.shape[-2], g.shape[-1]
        wdt, sr = cm._resolve_wire_codec(ctx.wire_dtype, g.dtype)
        gw = cm._wire_cast(g.reshape(-1, full), wdt, stochastic=sr) \
            .reshape(g.shape)
        acc = gw[..., 0, :].float() if gw.dtype == torch.bfloat16 \
            else gw[..., 0, :]
        for i in range(1, dp):
            acc = acc + gw[..., i, :]
        gs = acc.to(gw.dtype).reshape(*g.shape[:-2], dp, full // dp)
        return gs.to(g.dtype), None


def _bucket_gather(shard: torch.Tensor, wire_dtype=None, dim: int = 0):
    """The dp all-gather of flat shards whose dp axis is ``dim`` (the flat
    payload last): each dp rank gets the whole bucket. Its gradient is the
    reduce-scatter staged in ``wire_dtype`` (``cm._resolve_wire_codec``:
    None follows ``ACCLConfig.cmatmul_wire_dtype``, "off" full
    precision)."""
    moved = shard.movedim(dim, -2)
    return _BucketGather.apply(moved, wire_dtype).movedim(-2, dim)


# ---------------------------------------------------------------------------
# block math (one copy shared by the fused and flat schedules)
# ---------------------------------------------------------------------------

def _attention(q, k, v):
    """(H, S, dh) scaled-dot-product attention: the flash kernel when the
    sequence fits its 128-block tiling, the same math in plain f32
    otherwise (tiny geometries). Both schedules of a geometry take the same
    branch."""
    if q.shape[1] % 128 == 0:
        from ..ops import flash
        return flash.flash_attention(q, k, v)
    sc = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * sc
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float())


def _tp_sum(a: torch.Tensor, tp: int) -> torch.Tensor:
    """Megatron's tp ``psum`` over axis 1 of (G, tp, ...), every tp rank
    holding the sum."""
    if tp == 1:
        return a
    return a.sum(1, keepdim=True).expand_as(a)


def _attn_sublayer(x, bucket, d_model: int, tp: int, n_heads: int):
    """x (G, tp, b, d) + each rank's gathered attention bucket (G, tp,
    >= 4·d·dtp) -> x + attn(x). Heads are tp-sharded: each tp rank runs its
    n_heads/tp heads (all G * tp * n_heads/tp heads in one attention call)
    and the output projection's partial products are summed over tp."""
    dtp, _ = _attn_sizes(d_model, tp)
    G, _, b, d = x.shape
    wqkv = bucket[..., :3 * d_model * dtp].reshape(G, tp, d_model, 3 * dtp)
    wo = bucket[..., 3 * d_model * dtp:4 * d_model * dtp] \
        .reshape(G, tp, dtp, d_model)
    qkv = torch.matmul(x.float(), wqkv.float())
    q, k, v = qkv.split(dtp, dim=-1)             # (G, tp, b, dtp) each
    heads_tp = n_heads // tp
    dh = dtp // heads_tp

    def to_heads(t):
        return t.reshape(G * tp, b, heads_tp, dh).transpose(1, 2) \
            .reshape(G * tp * heads_tp, b, dh).contiguous()

    o = _attention(to_heads(q), to_heads(k), to_heads(v)).float()
    o = o.reshape(G, tp, heads_tp, b, dh).transpose(2, 3) \
        .reshape(G, tp, b, dtp)
    a = torch.matmul(o, wo.float())
    return x + _tp_sum(a, tp)


def _mlp_sublayer(x, mm1, mm2, tp: int):
    """x (G, tp, b, d) -> x + W2(gelu(W1 x)) with the two matmuls supplied
    by the schedule (fused all-gather x matmuls or plain products over
    gathered weights), in the transposed panel layout: ``mm1`` maps (G, tp,
    d, b) to (G, tp, h_tp, b), ``mm2`` (G, tp, h_tp, b) to (G, tp, d, b)."""
    u = F.gelu(mm1(x.transpose(-2, -1)), approximate="tanh")
    yt = mm2(u)
    return x + _tp_sum(yt, tp).transpose(-2, -1)
