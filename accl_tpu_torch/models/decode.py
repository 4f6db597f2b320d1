"""Continuous-batching decode and chunked prefill over a paged KV cache
(counterpart: ``accl_tpu/models/decode.py``): one attention block of a
served model under tensor parallelism.

* The **paged KV cache** is :func:`..ops.flash.flash_decode`'s layout:
  pools of fixed-size pages per KV head, indexed by a per-slot block table,
  so a growing sequence changes values, never shapes.
* **Continuous batching** is slot bookkeeping over it: :func:`admit` and
  :func:`retire` rewrite a slot's length and flag.
* The **decode step** (:func:`build_decode_step`) projects each slot's
  token to q, k and v, appends k and v to the cache, runs paged attention
  and the output projection. The **prefill step** (:func:`build_prefill_step`)
  does the same for one page-granular chunk of one slot's prompt.

Layout. Every tensor-parallel rank is a row of the first axis of the
weights (the ``models/mlp.py`` convention): rank r holds q, k and v column
blocks and the output row block of its heads,

  wq (tp, d_model, H/tp · hd), wk, wv (tp, d_model, H_kv/tp · hd),
  wo (tp, H/tp · hd, d_model).

The pools stay global, (H_kv, n_pages, page, hd): rank r owns KV heads
``[r·H_kv/tp, (r+1)·H_kv/tp)``, which is the JAX ``P(TP_AXIS)`` sharding
of their first axis, and q is laid out (slots, H, hd) with each rank's
heads contiguous. So one kernel launch per step computes every rank's
local attention, where the JAX program makes one per rank inside one
``shard_map``. The projections ride the fused collective matmuls
(``device_api.all_gather_matmul`` and ``matmul_reduce_scatter``) where
``cm.agmm_engages`` and ``cm.mmrs_engages`` say so at the step's shapes,
as in the JAX step, and otherwise the psum baseline, the same math.

The pools are written in place (the JAX step returns new ones): a state
returned by a step shares its pools with the state it was given.

Still to port (``ROADMAP.md`` queue 1, item 14): the speculative step,
rollback and page handoff, and the token publication.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device_api as dapi
from ..communicator import Communicator
from ..obs import metrics
from ..ops import collective_matmul as cm
from ..ops import flash


class DecodeParams(NamedTuple):
    """One attention block's projections in the rank layout (module
    docstring): wq (tp, d_model, H/tp · hd), wk and wv (tp, d_model,
    H_kv/tp · hd), wo (tp, H/tp · hd, d_model)."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor


class DecodeState(NamedTuple):
    """The session's cache and slot bookkeeping: pools (H_kv, n_pages,
    page, hd), block_tables (slots, pages_max) int32 (disjoint chains,
    always valid pool indices), seq_lens (slots,) int32, active (slots,)
    bool. Every shape is fixed by (slots, pages_max, page)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    seq_lens: torch.Tensor
    active: torch.Tensor


def shard_params(wq, wk, wv, wo, tp: int) -> DecodeParams:
    """Dense projections, wq (d_model, H·hd), wk and wv (d_model,
    H_kv·hd), wo (H·hd, d_model), to the rank layout. Every rank must own
    whole GQA groups: ``H % tp == 0`` and ``H_kv % tp == 0``."""
    d_model = wq.shape[0]
    hd_h, hd_kv = wq.shape[1], wk.shape[1]
    if hd_h % tp or hd_kv % tp:
        raise ValueError(f"q width {hd_h} / kv width {hd_kv} not divisible "
                         f"by tp {tp}")

    def cols(w):
        return w.reshape(d_model, tp, -1).transpose(0, 1).contiguous()

    return DecodeParams(wq=cols(wq), wk=cols(wk), wv=cols(wv),
                        wo=wo.reshape(tp, hd_h // tp, -1).contiguous())


def init_decode_params(gen: torch.Generator, d_model: int, n_heads: int,
                       n_kv_heads: int, head_dim: int, tp: int,
                       dtype=torch.float32) -> DecodeParams:
    """Random projections from ``gen`` (on its device), scaled as the JAX
    package scales them (q, k, v by sqrt(1/d_model), o by sqrt(1/(H·hd))),
    in the rank layout."""
    if n_heads % n_kv_heads:
        raise ValueError(f"n_heads {n_heads} % n_kv_heads {n_kv_heads}")
    if n_heads % tp or n_kv_heads % tp:
        raise ValueError(f"heads {n_heads}/{n_kv_heads} not divisible by "
                         f"tp {tp}")
    dev = gen.device

    def r(rows, cols, s):
        return (torch.randn((rows, cols), generator=gen, device=dev)
                * s).to(dtype)

    s = (1.0 / d_model) ** 0.5
    return shard_params(
        r(d_model, n_heads * head_dim, s),
        r(d_model, n_kv_heads * head_dim, s),
        r(d_model, n_kv_heads * head_dim, s),
        r(n_heads * head_dim, d_model, (1.0 / (n_heads * head_dim)) ** 0.5),
        tp)


def params_from_jax(params, comm: Communicator) -> DecodeParams:
    """A JAX ``DecodeParams`` (any four arrays numpy can read, global
    shapes) in the rank layout over ``comm``'s ranks, on its device."""
    dense = [torch.from_numpy(np.array(t, dtype=np.float32, copy=True))
             for t in (params.wq, params.wk, params.wv, params.wo)]
    dt = _torch_dtype(params.wq)
    return DecodeParams(*(t.to(comm.device, dt) for t in shard_params(
        *dense, comm.world_size)))


def _torch_dtype(a):
    name = str(getattr(a, "dtype", "float32"))
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8,
            "int32": torch.int32, "bool": torch.bool}[name]


def state_from_jax(state, device="cuda") -> DecodeState:
    """A JAX ``DecodeState`` (global pools, as numpy reads them) on
    ``device``, pools in their at-rest dtype."""
    def conv(a):
        dt = _torch_dtype(a)
        host = np.array(a, dtype=np.float32 if dt == torch.bfloat16
                        else None, copy=True)
        return torch.from_numpy(host).to(device, dt)

    return DecodeState(*(conv(a) for a in state))


def init_decode_state(slots: int, pages_max: int, page: int,
                      n_kv_heads: int, head_dim: int,
                      dtype=torch.float32, kv_dtype: Optional[str] = None,
                      device="cuda") -> DecodeState:
    """Zeroed pools in the at-rest dtype of codec ``kv_dtype`` (None: the
    ``ACCLConfig.kv_cache_dtype`` register) and the canonical disjoint
    tables, slot b owning pool pages ``[b·pages_max, (b+1)·pages_max)``.
    Slots start retired."""
    n_pages = slots * pages_max
    store = flash.kv_storage_dtype(dtype, kv_dtype)
    shape = (n_kv_heads, n_pages, page, head_dim)
    return DecodeState(
        k_pages=torch.zeros(shape, dtype=store, device=device),
        v_pages=torch.zeros(shape, dtype=store, device=device),
        block_tables=torch.arange(n_pages, dtype=torch.int32,
                                  device=device).reshape(slots, pages_max),
        seq_lens=torch.zeros((slots,), dtype=torch.int32, device=device),
        active=torch.zeros((slots,), dtype=torch.bool, device=device))


def _set_slot(state: DecodeState, slot: int, live: bool) -> DecodeState:
    lens, active = state.seq_lens.clone(), state.active.clone()
    lens[slot] = 0
    active[slot] = live
    return state._replace(seq_lens=lens, active=active)


def admit(state: DecodeState, slot: int) -> DecodeState:
    """A fresh sequence in ``slot``: length 0, live. Stale page content is
    unreachable past the length."""
    return _set_slot(state, slot, True)


def retire(state: DecodeState, slot: int) -> DecodeState:
    """Release ``slot``: it stops advancing and answers zeros; its table
    row stays valid."""
    return _set_slot(state, slot, False)


def free_slots(state: DecodeState) -> list:
    """The retired slots' indices."""
    return [int(i) for i in np.nonzero(~state.active.cpu().numpy())[0]]


def full_slots(state: DecodeState) -> list:
    """Active slots whose cache is at capacity (``pages_max · page``): the
    step no longer appends for them."""
    cap = state.block_tables.shape[1] * state.k_pages.shape[2]
    full = state.active.cpu().numpy() & (state.seq_lens.cpu().numpy() >= cap)
    return [int(i) for i in np.nonzero(full)[0]]


# ---------------------------------------------------------------------------
# engage introspection
# ---------------------------------------------------------------------------

def decode_engages(slots: int, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, tp: int,
                   overlap: Optional[bool] = None,
                   bidirectional: bool = True, wire_dtype=None,
                   dtype=torch.float32) -> bool:
    """True when the decode step's projections would ride the fused
    collective-matmul kernels at these shapes."""
    if tp <= 1 or slots % tp or n_heads % tp or n_kv_heads % tp:
        return False
    qkv_cols = (n_heads + 2 * n_kv_heads) // tp * head_dim
    return (cm.agmm_engages(slots // tp, d_model, qkv_cols, tp, dtype,
                            overlap, bidirectional, wire_dtype=wire_dtype)
            and cm.mmrs_engages(slots, n_heads // tp * head_dim, d_model,
                                tp, dtype, overlap, bidirectional,
                                wire_dtype=wire_dtype))


def decode_engage_reasons(slots: int, d_model: int, n_heads: int,
                          n_kv_heads: int, head_dim: int, tp: int,
                          page: Optional[int] = None,
                          pages_max: Optional[int] = None,
                          spec_tokens: int = 1,
                          prefill_chunk: Optional[int] = None,
                          overlap: Optional[bool] = None,
                          bidirectional: bool = True, wire_dtype=None,
                          dtype=torch.float32,
                          kv_dtype: Optional[str] = None) -> dict:
    """Every leg's verdict (None or "ok": engages), as the JAX package
    derives it: ``qkv`` and ``wo`` from ``cm.agmm_engage_reason`` and
    ``mmrs_engage_reason``, ``kv_quant`` the active codec, and with ``page``
    and ``pages_max`` ``attention`` (the decode plan), ``spec`` (the plan
    at ``span = spec_tokens``) and ``prefill`` (the prefill plan at
    ``prefill_chunk``, None: its own pick), at the per-rank head counts."""
    reasons = {}
    if tp <= 1 or slots % tp or n_heads % tp or n_kv_heads % tp:
        reasons["qkv"] = reasons["wo"] = "geometry"
    else:
        qkv_cols = (n_heads + 2 * n_kv_heads) // tp * head_dim
        reasons["qkv"] = cm.agmm_engage_reason(
            slots // tp, d_model, qkv_cols, tp, dtype, overlap,
            bidirectional, wire_dtype=wire_dtype)
        reasons["wo"] = cm.mmrs_engage_reason(
            slots, n_heads // tp * head_dim, d_model, tp, dtype, overlap,
            bidirectional, wire_dtype=wire_dtype)
    kv_mode = kv_dtype or flash.get_kv_cache_dtype()
    reasons["kv_quant"] = kv_mode
    if page is not None and pages_max is not None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        kvi = torch.empty((), dtype=flash.kv_storage_dtype(
            dtype, kv_mode)).element_size()
        div = tp > 1 and n_heads % tp == 0 and n_kv_heads % tp == 0
        h_l = n_heads // tp if div else n_heads
        hkv_l = n_kv_heads // tp if div else n_kv_heads
        _, reasons["attention"] = flash.decode_plan(
            slots, h_l, hkv_l, head_dim, page, pages_max, itemsize,
            kv_itemsize=kvi)
        _, reasons["spec"] = flash.decode_plan(
            slots, h_l, hkv_l, head_dim, page, pages_max, itemsize,
            span=spec_tokens, kv_itemsize=kvi)
        _, reasons["prefill"] = flash.prefill_plan(
            h_l, hkv_l, head_dim, page, pages_max, itemsize,
            chunk=prefill_chunk, kv_itemsize=kvi)
    return reasons


def accept_lengths(draft_ok) -> torch.Tensor:
    """Per-slot accepted-prefix length of a (slots, k) draft-match mask:
    the number of leading True entries."""
    ok = torch.as_tensor(np.asarray(draft_ok) if not isinstance(
        draft_ok, torch.Tensor) else draft_ok).to(torch.int64)
    return torch.cumprod(ok, dim=1).sum(dim=1)


def note_serving_tokens(phase: str, n: int, accepted: bool = True) -> None:
    """Bump ``accl_serving_tokens_total{phase, accepted}`` (phase prefill,
    decode or verify)."""
    metrics.inc("accl_serving_tokens_total", float(n),
                (("phase", phase),
                 ("accepted", "true" if accepted else "false")))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _project_qkv(p: DecodeParams, x: torch.Tensor, fused: bool,
                 overlap, wire_dtype):
    """x (rows, d_model) -> every rank's [q | k | v] columns, (tp, rows,
    cols) f32: the fused all-gather x matmul over x's row shards, or the
    local matmuls."""
    tp = p.wq.shape[0]
    rows, d_model = x.shape
    wqkv = torch.cat([p.wq, p.wk, p.wv], dim=2)
    if fused:
        return dapi.all_gather_matmul(x.reshape(tp, rows // tp, d_model),
                                      wqkv, overlap=overlap,
                                      wire_dtype=wire_dtype)
    return torch.matmul(x.float(), wqkv.float())


def _split_heads(qkv: torch.Tensor, h_l: int, hkv_l: int, hd: int):
    """(tp, rows, cols) -> q (rows, H, hd), k and v (rows, H_kv, hd), each
    rank's heads contiguous."""
    tp, rows, _ = qkv.shape

    def heads(t, n):
        return t.reshape(tp, rows, n, hd).transpose(0, 1).reshape(
            rows, tp * n, hd)

    q, k, v = torch.split(qkv, [h_l * hd, hkv_l * hd, hkv_l * hd], dim=2)
    return heads(q, h_l), heads(k, hkv_l), heads(v, hkv_l)


def _project_out(p: DecodeParams, attn: torch.Tensor, x: torch.Tensor,
                 fused: bool, overlap, wire_dtype) -> torch.Tensor:
    """attn (rows, H, hd) -> (rows, d_model) f32: each rank's heads through
    its wo rows, summed over ranks (the fused matmul x reduce-scatter and
    the gather of its rows, or the psum baseline)."""
    tp = p.wo.shape[0]
    rows = attn.shape[0]
    o = attn.reshape(rows, tp, -1).transpose(0, 1)   # (tp, rows, H/tp·hd)
    if fused:
        y_s = dapi.matmul_reduce_scatter(o.to(x.dtype).contiguous(), p.wo,
                                         overlap=overlap,
                                         wire_dtype=wire_dtype)
        return y_s.reshape(rows, -1)
    return torch.matmul(o.float(), p.wo.float()).sum(0)


def _engages(p: DecodeParams, rows: int, d_model: int, x_dtype, overlap,
             wire_dtype) -> bool:
    """The JAX step's fused-or-psum choice at these shapes."""
    tp = p.wq.shape[0]
    cols = p.wq.shape[2] + p.wk.shape[2] + p.wv.shape[2]
    return (tp > 1 and rows % tp == 0
            and cm.agmm_engages(rows // tp, d_model, cols, tp, x_dtype,
                                overlap, wire_dtype=wire_dtype,
                                w_dtype=p.wq.dtype)
            and cm.mmrs_engages(rows, p.wo.shape[1], d_model, tp, x_dtype,
                                overlap, wire_dtype=wire_dtype,
                                w_dtype=p.wo.dtype))


def _geometry(p: DecodeParams, state: DecodeState):
    tp = p.wq.shape[0]
    hkv, _, _, hd = state.k_pages.shape
    return tp, p.wq.shape[2] // hd, hkv // tp, hd


def _step_local(p: DecodeParams, state: DecodeState, x: torch.Tensor,
                overlap: Optional[bool] = None, wire_dtype=None,
                decode_mode: Optional[str] = None):
    """One decode step over every rank (the JAX ``_step_local`` of each):
    x (slots, d_model) -> (y (slots, d_model), state'). Projection, append
    (retired slots and full ones write nothing), paged attention over every
    rank's heads in one call, output projection; retired slots answer
    zeros."""
    slots, d_model = x.shape
    tp, h_l, hkv_l, hd = _geometry(p, state)
    fused = _engages(p, slots, d_model, x.dtype, overlap, wire_dtype)
    qkv = _project_qkv(p, x, fused, overlap, wire_dtype)
    q, k_new, v_new = _split_heads(qkv, h_l, hkv_l, hd)
    k_pages, v_pages, seq_lens = flash.kv_cache_append(
        state.k_pages, state.v_pages, state.block_tables, state.seq_lens,
        k_new, v_new, active=state.active)
    attn = flash.flash_decode(q.to(x.dtype), k_pages, v_pages,
                              state.block_tables, seq_lens,
                              decode_mode=decode_mode)
    y = _project_out(p, attn, x, fused, overlap, wire_dtype)
    y = torch.where(state.active[:, None], y.to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return y, DecodeState(k_pages, v_pages, state.block_tables, seq_lens,
                          state.active)


def _prefill_step_local(p: DecodeParams, state: DecodeState,
                        x: torch.Tensor, slot: int,
                        live: Optional[int] = None,
                        overlap: Optional[bool] = None, wire_dtype=None,
                        prefill_mode: Optional[str] = None):
    """One chunk of one slot's prompt over every rank (the JAX
    ``_prefill_step_local`` of each): x (C, d_model) -> (y (C, d_model),
    state'); rows past ``live`` are padding."""
    C, d_model = x.shape
    tp, h_l, hkv_l, hd = _geometry(p, state)
    fused = _engages(p, C, d_model, x.dtype, overlap, wire_dtype)
    qkv = _project_qkv(p, x, fused, overlap, wire_dtype)
    q, k_new, v_new = _split_heads(qkv, h_l, hkv_l, hd)
    out, k_pages, v_pages, seq_lens = flash.flash_prefill(
        q.to(x.dtype), k_new, v_new, state.k_pages, state.v_pages,
        state.block_tables, state.seq_lens, slot, live=live,
        prefill_mode=prefill_mode)
    y = _project_out(p, out, x, fused, overlap, wire_dtype)
    return y.to(x.dtype), DecodeState(k_pages, v_pages, state.block_tables,
                                      seq_lens, state.active)


def _check_tp(comm: Communicator, p: DecodeParams) -> None:
    if p.wq.shape[0] != comm.world_size:
        raise ValueError(f"params hold {p.wq.shape[0]} ranks, the "
                         f"communicator {comm.world_size}")


def build_decode_step(comm: Communicator, overlap: Optional[bool] = None,
                      wire_dtype=None, decode_mode: Optional[str] = None):
    """The continuous-batching decode step over ``comm``'s tp ranks:
    ``step(params, state, x) -> (y, state')``, x (slots, d_model) the
    current token's hidden state per slot, y its attention-block output
    (retired slots: zeros). ``overlap`` and ``wire_dtype`` steer the
    projections (None: the session registers), ``decode_mode`` the
    attention (None: ``ACCLConfig.flash_decode``). Each call's dispatch is
    timed into ``accl_latency_dispatch_seconds{path="decode"}`` and counts
    ``slots`` tokens in ``accl_serving_tokens_total``."""

    def step(p: DecodeParams, state: DecodeState, x: torch.Tensor):
        _check_tp(comm, p)
        t0 = metrics.tick()
        out = _step_local(p, state, x, overlap, wire_dtype,
                                decode_mode)
        metrics.note_latency_dispatch("decode", t0)
        note_serving_tokens("decode", x.shape[0])
        return out

    return step


def build_prefill_step(comm: Communicator, overlap: Optional[bool] = None,
                       wire_dtype=None, prefill_mode: Optional[str] = None):
    """The chunked-prefill step over ``comm``'s tp ranks: ``step(params,
    state, x, slot, live=None) -> (y, state')``, x (C, d_model) one
    page-granular chunk of slot ``slot``'s prompt, ``live`` the real rows of
    a final partial chunk (default C; y's rows past it are padding). Admit
    the slot first, then one step per chunk. Dispatch is timed into
    ``accl_latency_dispatch_seconds{path="prefill"}``; ``live`` tokens count
    in ``accl_serving_tokens_total{phase="prefill"}``."""

    def step(p: DecodeParams, state: DecodeState, x: torch.Tensor,
             slot: int, live: Optional[int] = None):
        _check_tp(comm, p)
        t0 = metrics.tick()
        out = _prefill_step_local(p, state, x, slot, live, overlap,
                                 wire_dtype, prefill_mode)
        metrics.note_latency_dispatch("prefill", t0)
        note_serving_tokens("prefill",
                            x.shape[0] if live is None else int(live))
        return out

    return step


def _dense(p: DecodeParams):
    """The rank layout back to the dense (global) projections."""
    tp, d_model = p.wq.shape[:2]

    def cols(w):
        return w.transpose(0, 1).reshape(d_model, -1)

    return cols(p.wq), cols(p.wk), cols(p.wv), p.wo.reshape(-1,
                                                            p.wo.shape[2])


def decode_step_reference(p: DecodeParams, state: DecodeState,
                          x: torch.Tensor):
    """One decode step on one device from the dense projections, the
    masked append and the unpaged attention (``decode_step_reference``):
    the oracle of both datapaths. Writes the pools in place, as the step
    does."""
    slots = x.shape[0]
    hkv, _, _, hd = state.k_pages.shape
    wq, wk, wv, wo = _dense(p)
    h = wq.shape[1] // hd
    xf = x.float()
    q = torch.matmul(xf, wq.float())
    k_new = torch.matmul(xf, wk.float()).reshape(slots, hkv, hd)
    v_new = torch.matmul(xf, wv.float()).reshape(slots, hkv, hd)
    k_pages, v_pages, seq_lens = flash.kv_cache_append(
        state.k_pages, state.v_pages, state.block_tables, state.seq_lens,
        k_new, v_new, active=state.active)
    attn = flash.flash_decode(q.reshape(slots, h, hd).to(x.dtype), k_pages,
                              v_pages, state.block_tables, seq_lens,
                              decode_mode="unpaged")
    y = torch.matmul(attn.reshape(slots, h * hd).float(), wo.float())
    y = torch.where(state.active[:, None], y.to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return y, DecodeState(k_pages, v_pages, state.block_tables, seq_lens,
                          state.active)
