"""Expert parallelism: a Mixture-of-Experts layer whose dispatch and combine
are the library's all-to-all (counterpart: ``accl_tpu/models/moe.py``).

Each rank owns ``E / world`` experts. Top-k routed tokens go to their
expert's rank in one all-to-all, the expert FFNs (ReLU, two matrices) run
there, and a second all-to-all brings the outputs home: the Switch-style
capacity-bounded schedule with static shapes, where tokens over capacity
keep their residual only.

Layout, every rank a row of the first axis:
  tokens   x: (world, n, d)
  dispatch  : (world, n, E, C) one-hot, token t -> (expert e, slot c)
  send      : (world, E, C, d), row block e goes to rank e // e_local
  recv      : (world, e_local, world*C, d), my experts' tokens by source
  combine   : the transpose of dispatch, weighted by the router gates

``overlap=True`` runs the two exchanges and the expert matmuls through the
fused dispatch and combine kernels (:mod:`..ops.collective_alltoall`);
``overlap=False`` the unfused baseline (all-to-all, einsum, ReLU, einsum,
all-to-all). Both are differentiable: the router, ``w_in``, ``w_out`` and
the tokens get their gradients through autograd, the fused path's from the
dual kernels (dx) and the a2a-wgrad kernel (dw).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device_api as dapi
from ..communicator import Communicator
from ..ops import collective_alltoall as ca
from ..ops import collective_matmul as cm


class MoEParams(NamedTuple):
    router: torch.Tensor  # (d, E), replicated
    w_in: torch.Tensor    # (E, d, h), experts r*e_local.. on rank r
    w_out: torch.Tensor   # (E, h, d)


def init_params(gen: torch.Generator, comm: Communicator, d_model: int,
                d_hidden: int, n_experts: int) -> MoEParams:
    """Random parameters from ``gen`` (on the generator's device), scaled
    as the JAX package scales them: router 0.02, w_in sqrt(2/d_model),
    w_out sqrt(2/d_hidden)."""
    if n_experts % comm.world_size != 0:
        raise ValueError(f"n_experts {n_experts} % world {comm.world_size} "
                         f"!= 0")

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    return MoEParams(
        router=normal(d_model, n_experts) * 0.02,
        w_in=normal(n_experts, d_model, d_hidden) * (2.0 / d_model) ** 0.5,
        w_out=normal(n_experts, d_hidden, d_model) * (2.0 / d_hidden) ** 0.5)


def shard_params(params: MoEParams, comm: Communicator) -> MoEParams:
    """The parameters on the communicator's device: the router replicated,
    the experts split over the ranks in order (rank r's are rows r*e_local
    .. of w_in and w_out)."""
    return MoEParams(*(t.to(comm.device).contiguous() for t in params))


def params_from_jax(params, device) -> MoEParams:
    """Carry a JAX ``MoEParams`` (or any triple of arrays numpy can read)
    into the port, on ``device``."""
    return MoEParams(*(torch.from_numpy(np.array(t, copy=True)).to(device)
                       for t in (params.router, params.w_in, params.w_out)))


def _route(x, router, n_experts: int, capacity: int, top_k: int):
    """(probs, top-k expert ids, dispatch, combine) of every rank's tokens.
    Ties break toward the lower expert id (``lax.top_k``'s rule: a stable
    descending sort); every first choice takes its slot before any second
    choice, in token order."""
    probs = torch.softmax(x @ router, dim=-1)               # (P, n, E)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    gates = topv if top_k == 1 else topv / topv.sum(dim=-1, keepdim=True)
    P, n, _ = x.shape
    disp = torch.zeros((P, n, n_experts, capacity), dtype=x.dtype,
                       device=x.device)
    comb = torch.zeros_like(disp)
    prev = torch.zeros((P, n_experts), dtype=torch.int64, device=x.device)
    for j in range(top_k):
        ej = topi[..., j]                                   # (P, n)
        oh = F.one_hot(ej, n_experts)                       # (P, n, E)
        pos = torch.cumsum(oh, dim=1) * oh - 1
        slot = pos.max(dim=2).values + torch.gather(prev, 1, ej)
        keep = (slot < capacity).to(x.dtype)
        sel = (oh.to(x.dtype)[..., :, None]
               * F.one_hot(slot.clamp(0, capacity - 1),
                           capacity).to(x.dtype)[..., None, :]
               * keep[..., None, None])                     # (P, n, E, C)
        disp = disp + sel
        comb = comb + sel * gates[..., j, None, None]
        prev = prev + oh.sum(dim=1)
    return probs, topi, disp, comb


def build_moe_forward(comm: Communicator, n_experts: int, capacity: int,
                      top_k: int = 1, return_aux: bool = False,
                      overlap: bool = None, wire_dtype=None):
    """The expert-parallel MoE forward: ``prog(params, x)`` with x (world,
    n, d) and ``params`` from :func:`shard_params`, returning (world, n, d)
    (and, with ``return_aux``, the Switch load-balancing loss over the
    global batch as a (world,) tensor).

    ``capacity`` is the per-(rank, expert) token budget C; ``top_k`` routes
    each token to its k best experts with renormalized gates (the raw
    router probability at k = 1). ``overlap=None`` follows the session
    (``ACCLConfig.moe_overlap`` and ``a2a_matmul_threshold``); the layer
    takes the fused kernels only when they engage for both directions,
    else it runs the unfused baseline and counts the decline under
    ``accl_cmatmul_fallback_total{op="moe_alltoall"}`` (a requested
    ``off`` is not counted). ``wire_dtype`` stages the exchanges compressed
    (None: the session ``cmatmul_wire_dtype``; "off": full precision)."""
    world = comm.world_size
    if n_experts % world != 0:
        raise ValueError(f"n_experts {n_experts} % world {world} != 0")
    e_local = n_experts // world
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k {top_k} must be in [1, {n_experts}]")

    def prog(params: MoEParams, x: torch.Tensor):
        P, n, d = x.shape
        if P != world:
            raise ValueError(f"x has {P} rank rows, world is {world}")
        probs, topi, disp, comb = _route(x, params.router, n_experts,
                                         capacity, top_k)
        send = torch.einsum("pnec,pnd->pecd", disp, x)      # (P, E, C, d)
        d_hidden = params.w_in.shape[2]
        w_in = params.w_in.reshape(world, e_local, d, d_hidden)
        w_out = params.w_out.reshape(world, e_local, d_hidden, d)
        # the two datapaths stage and return the same dtypes
        h_dtype = torch.promote_types(x.dtype, w_in.dtype)
        out_dtype = torch.promote_types(h_dtype, w_out.dtype)
        reason = None
        if world > 1:
            reason = (ca.a2a_engage_reason(
                          e_local, capacity, d, d_hidden, world, x.dtype,
                          overlap, wire_dtype=wire_dtype, w_dtype=w_in.dtype,
                          direction="dispatch")
                      or ca.a2a_engage_reason(
                          e_local, capacity, d, d_hidden, world, h_dtype,
                          overlap, wire_dtype=wire_dtype,
                          w_dtype=w_out.dtype, direction="combine"))
        if world > 1 and reason is None:
            h = torch.relu(dapi.alltoall_matmul(send, w_in, overlap=overlap,
                                                wire_dtype=wire_dtype))
            back = dapi.matmul_alltoall(h.to(h_dtype), w_out,
                                        overlap=overlap,
                                        wire_dtype=wire_dtype).to(out_dtype)
        else:
            if world > 1 and reason != "off":
                cm._note_fallback("moe_alltoall", reason)
            recv = ca._all_to_all_in(send, e_local).to(h_dtype)
            h = torch.relu(torch.einsum("pecd,pedh->pech", recv,
                                        w_in.to(h_dtype)))
            y = torch.einsum("pech,pehd->pecd", h.to(out_dtype),
                             w_out.to(out_dtype))
            back = ca._all_to_all_out(y)                    # (P, E, C, d)
        out = torch.einsum("pnec,pecd->pnd", comb.to(back.dtype), back)
        result = x + out
        if not return_aux:
            return result
        # Switch aux loss over the global batch: the psum is a sum over
        # the rank rows, so every rank holds the same scalar
        f = F.one_hot(topi[..., 0], n_experts).float().sum(dim=1).sum(0)
        p = probs.float().sum(dim=1).sum(0)
        n_tot = n * world
        aux = n_experts * torch.sum((f / n_tot) * (p / n_tot))
        return result, aux.reshape(1).expand(world).clone()

    return prog


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().double().numpy()
    return np.asarray(t, np.float64)


def reference_moe(params, x, n_experts: int, capacity: int,
                  top_k: int = 1) -> np.ndarray:
    """Host reference in float64: the same capacity-bounded top-k MoE,
    computed rank by rank with no parallelism (slots in token order, every
    first choice before any second one; ties toward the lower expert
    id)."""
    x = _f64(x)
    world, n, _ = x.shape
    router, w_in, w_out = (_f64(t) for t in (params.router, params.w_in,
                                             params.w_out))
    out = x.copy()
    rows = np.arange(n)
    for r in range(world):
        logits = x[r] @ router
        e_x = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e_x / e_x.sum(-1, keepdims=True)
        order = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
        counts = np.zeros(n_experts, np.int64)
        kept = np.zeros((n, top_k), bool)
        for j in range(top_k):
            for t in range(n):
                e = order[t, j]
                if counts[e] < capacity:
                    counts[e] += 1
                    kept[t, j] = True
        gsum = (probs[rows[:, None], order].sum(-1) if top_k > 1
                else np.ones(n))
        for j in range(top_k):
            for e in range(n_experts):
                toks = np.nonzero(kept[:, j] & (order[:, j] == e))[0]
                if toks.size == 0:
                    continue
                h = np.maximum(x[r, toks] @ w_in[e], 0.0)
                out[r, toks] += (h @ w_out[e]) * \
                    (probs[toks, e] / gsum[toks])[:, None]
    return out
