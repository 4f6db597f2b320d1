"""Context (sequence) parallelism: ring attention, its load-balanced zigzag
variant and all-to-all (Ulysses) resharding (counterpart:
``accl_tpu/parallel/context.py``).

Tensors carry every rank as a row of their first axis. Ring and zigzag take
q, k, v (world, n, d): rank r owns sequence block r (zigzag: half blocks r
and 2W-1-r of the 2W halves, see :func:`zigzag_layout`). Ulysses takes
(world, n, H, d). Outputs have the inputs' shape and dtype; softmax state is
f32 whatever the inputs. All three are differentiable through autograd.

The JAX ring hops K/V one step forward with ``lax.ppermute`` after every
step, so at step s rank r holds block (r - s) mod W; here that hop is
``torch.roll`` over the rank axis, the plain-torch analog of the XLA
collective, as the port's other non-PALLAS programs are. Under ``causal``
only ranks r >= s are live at step s (the arriving block is not in their
future): the JAX layer skips the others with ``lax.cond`` on a TPU (and
weights them out by an lse of -1e30 on the CPU); here every step runs over
the live ranks' slice ``[s:]`` only, and the others keep their carry, which
is the same result.

``use_flash=True`` runs each step through :func:`..ops.flash.
flash_attention_lse` with the ranks as its head axis (one kernel launch per
step and branch on the card) and merges (out, lse) pairs by log-sum-exp
weighting (:func:`_merge_partials`); the zigzag schedule's branches split
the same way (the early half for ranks r >= s, the late half for r < s).
Ulysses' two all-to-alls are transposing copies: one card holds every
rank's head group, so its flash call takes all H heads of the full
sequence in one launch. ``use_flash=False`` runs the JAX package's
natural-exp online softmax (:func:`_online_block`) with -inf masks.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..communicator import Communicator
from ..ops import flash as _flash

_F32 = torch.float32
_INF = float("inf")


def _online_block(q, kb, vb, acc, m, l, qpos, kpos, causal: bool,
                  scale: float):
    """One blockwise online-softmax step over any leading batch axes: q (...,
    n, d); kb/vb (..., nb, d); acc (..., n, d) f32; m/l (..., n) f32;
    positions qpos (..., n), kpos (..., nb). The scores and the state are
    f32; the matmul operands are the inputs' values (exact in f32), p cast
    to v's dtype for P·V."""
    scores = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    if causal:
        mask = qpos[..., :, None] >= kpos[..., None, :]
        scores = torch.where(mask, scores, -_INF)
    m_new = torch.maximum(m, scores.amax(-1))
    # a fully masked row keeps m = -inf and p = 0
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    fin = torch.isfinite(m)
    alpha = torch.exp(torch.where(fin, m - m_new, -_INF))
    alpha = torch.where(fin, alpha, 0.0)
    l_new = l * alpha + p.sum(-1)
    pv = torch.matmul(p.to(vb.dtype).float(), vb.float())
    return acc * alpha[..., None] + pv, m_new, l_new


def _merge_partials(o_c, lse_c, o_s, lse_s):
    """Merge two normalized partial attentions by their log-sum-exps: out =
    (w_c o_c + w_s o_s) / (w_c + w_s), w = exp(lse - max). A fully masked
    partial carries lse = -1e30, so its weight is an exact zero."""
    m = torch.maximum(lse_c, lse_s)
    wc = torch.exp(lse_c - m)
    ws = torch.exp(lse_s - m)
    tot = wc + ws
    safe = torch.where(tot > 0, tot, 1.0)
    o = (o_c * wc[..., None] + o_s * ws[..., None]) / safe[..., None]
    return o, m + torch.log(safe)


def _norm(acc, l, dtype):
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).to(dtype)


def _check(comm: Communicator, world: int, *xs):
    for x in xs:
        if x.shape[0] != world or x.device.type != comm.device.type:
            raise ValueError(f"context-parallel inputs must be the "
                             f"communicator's (world={world}, ...) tensors "
                             f"on {comm.device}, got {tuple(x.shape)} on "
                             f"{x.device}")


def _step(state, lo: int, hi: int, fn):
    """Replace rows [lo, hi) of every tensor of ``state`` by ``fn`` of those
    rows (a branch that only some ranks take); the rest keep their carry."""
    if lo >= hi:
        return state
    new = fn(*(t[lo:hi] for t in state))
    return tuple(torch.cat([t[:lo], u, t[hi:]]) for t, u in zip(state, new))


def _flash_merge(q, kb, vb, causal: bool, sc: float):
    """The state update of one flash step over some ranks: the step's
    (out, lse) merged into the carry (o, lse)."""
    def fn(o_c, lse_c):
        o_s, lse_s = _flash.flash_attention_lse(q, kb, vb, causal=causal,
                                                scale=sc)
        return _merge_partials(o_c, lse_c, o_s.float(), lse_s)
    return fn


def _hop(x):
    """One forward ring hop of every rank's block: rank r receives rank
    r - 1's."""
    return torch.roll(x, 1, 0)


def build_ring_attention(comm: Communicator, causal: bool = False,
                         scale: Optional[float] = None,
                         use_flash: bool = False) -> Callable:
    """Ring attention over the communicator's ranks: q, k, v (world, n, d),
    rank r owning sequence block [r n, (r+1) n); returns (world, n, d), the
    exact softmax attention of the (world n)-long sequence, accumulated
    block by block as K/V travel the ring. ``use_flash`` needs n to be a
    multiple of the flash blocks (128)."""
    world = comm.world_size

    def body_flash(q, k, v):
        _check(comm, world, q, k, v)
        _, n, d = q.shape
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        st = (torch.zeros((world, n, d), dtype=_F32, device=q.device),
              torch.full((world, n), -1e30, dtype=_F32, device=q.device))
        kb, vb = k, v
        for s in range(world):
            # step 0 is the diagonal block (local causal mask = global);
            # later causal steps are live for ranks s.. only
            lo = s if causal else 0
            st = _step(st, lo, world, _flash_merge(
                q[lo:], kb[lo:], vb[lo:], causal and s == 0, sc))
            if s + 1 < world:
                kb, vb = _hop(kb), _hop(vb)
        return st[0].to(q.dtype)

    def body(q, k, v):
        _check(comm, world, q, k, v)
        _, n, d = q.shape
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        dev = q.device
        rank = torch.arange(world, device=dev)
        idx = torch.arange(n, device=dev)
        qpos = rank[:, None] * n + idx
        st = (torch.zeros((world, n, d), dtype=_F32, device=dev),
              torch.full((world, n), -_INF, dtype=_F32, device=dev),
              torch.zeros((world, n), dtype=_F32, device=dev))
        kb, vb = k, v
        for s in range(world):
            kpos = torch.remainder(rank - s, world)[:, None] * n + idx
            lo = s if causal else 0

            def attend(a, mm, ll, lo=lo, kb=kb, vb=vb, kpos=kpos):
                return _online_block(q[lo:], kb[lo:], vb[lo:], a, mm, ll,
                                     qpos[lo:], kpos[lo:], causal, sc)

            st = _step(st, lo, world, attend)
            if s + 1 < world:
                kb, vb = _hop(kb), _hop(vb)
        return _norm(st[0], st[2], q.dtype)

    return body_flash if use_flash else body


def _zigzag_index(world: int) -> np.ndarray:
    return np.stack([np.arange(world),
                     2 * world - 1 - np.arange(world)], 1).reshape(-1)


def zigzag_layout(x, world: int):
    """Permute a (S, ...) sequence-major tensor into the zigzag ring layout:
    rank r owns half blocks r and 2W-1-r of the 2W half blocks. Returns
    (world, S // world, ...)."""
    S = x.shape[0]
    h = S // (2 * world)
    halves = x.reshape(2 * world, h, *x.shape[1:])
    idx = torch.as_tensor(_zigzag_index(world), device=x.device)
    return halves[idx].reshape(world, 2 * h, *x.shape[1:])


def zigzag_unlayout(x, world: int):
    """Inverse of :func:`zigzag_layout`: (world, n, ...) -> (S, ...)."""
    n = x.shape[1]
    h = n // 2
    halves = x.reshape(2 * world, h, *x.shape[2:])
    inv = torch.as_tensor(np.argsort(_zigzag_index(world)), device=x.device)
    return halves[inv].reshape(2 * world * h, *x.shape[2:])


def build_zigzag_ring_attention(comm: Communicator,
                                scale: Optional[float] = None,
                                use_flash: bool = False) -> Callable:
    """Load-balanced causal ring attention in the zigzag layout: q, k, v
    (world, n, d) from :func:`zigzag_layout`, n even; the result equals
    dense causal attention of the un-permuted sequence (through
    :func:`zigzag_unlayout`). Every step the late q half attends the
    arriving early kv half in full, plus the early half against the early
    kv half on ranks r >= s (the arriving block is older) or the late half
    against the late kv half on ranks r < s; step 0 adds the two aligned
    causal diagonals. ``use_flash`` needs n / 2 to be a multiple of the
    flash blocks (128)."""
    world = comm.world_size

    def halves(q, k, v):
        _check(comm, world, q, k, v)
        n, d = q.shape[1:]
        if n % 2:
            raise ValueError(f"zigzag needs an even per-rank block, got {n}")
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        return n // 2, d, sc

    def body_flash(q, k, v):
        h, d, sc = halves(q, k, v)
        qA, qB = q[:, :h], q[:, h:]
        init = (torch.zeros((world, h, d), dtype=_F32, device=q.device),
                torch.full((world, h), -1e30, dtype=_F32, device=q.device))
        stA, stB = init, init
        kb, vb = k, v
        for s in range(world):
            kA, vA, kB, vB = kb[:, :h], vb[:, :h], kb[:, h:], vb[:, h:]
            # the late q half against the arriving early kv half: strictly
            # earlier positions, a full attend on every rank
            stB = _step(stB, 0, world, _flash_merge(qB, kA, vA, False, sc))
            if s == 0:
                # own kv: both diagonals are aligned causal blocks
                stA = _step(stA, 0, world, _flash_merge(qA, kA, vA, True,
                                                        sc))
                stB = _step(stB, 0, world, _flash_merge(qB, kB, vB, True,
                                                        sc))
            else:
                stA = _step(stA, s, world, _flash_merge(
                    qA[s:], kA[s:], vA[s:], False, sc))
                stB = _step(stB, 0, s, _flash_merge(
                    qB[:s], kB[:s], vB[:s], False, sc))
            if s + 1 < world:
                kb, vb = _hop(kb), _hop(vb)
        return torch.cat([stA[0], stB[0]], 1).to(q.dtype)

    def body(q, k, v):
        h, d, sc = halves(q, k, v)
        dev = q.device
        rank = torch.arange(world, device=dev)
        idx = torch.arange(h, device=dev)
        posA = rank[:, None] * h + idx
        posB = (2 * world - 1 - rank)[:, None] * h + idx
        qA, qB = q[:, :h], q[:, h:]
        init = (torch.zeros((world, h, d), dtype=_F32, device=dev),
                torch.full((world, h), -_INF, dtype=_F32, device=dev),
                torch.zeros((world, h), dtype=_F32, device=dev))
        stA, stB = init, init
        kb, vb = k, v
        for s in range(world):
            src = torch.remainder(rank - s, world)
            kposA = src[:, None] * h + idx
            kposB = (2 * world - 1 - src)[:, None] * h + idx
            kA, vA, kB, vB = kb[:, :h], vb[:, :h], kb[:, h:], vb[:, h:]

            def attend(qs, ks, vs, qp, kp, lo, hi):
                def fn(a, mm, ll):
                    return _online_block(qs[lo:hi], ks[lo:hi], vs[lo:hi], a,
                                         mm, ll, qp[lo:hi], kp[lo:hi], True,
                                         sc)
                return fn

            stB = _step(stB, 0, world, attend(qB, kA, vA, posB, kposA, 0,
                                              world))
            # early-vs-early where the arriving block is not newer (r >= s),
            # late-vs-late elsewhere; positional masks keep the diagonals
            stA = _step(stA, s, world, attend(qA, kA, vA, posA, kposA, s,
                                              world))
            stB = _step(stB, 0, s, attend(qB, kB, vB, posB, kposB, 0, s))
            if s == 0:
                stB = _step(stB, 0, world, attend(qB, kB, vB, posB, kposB,
                                                  0, world))
            if s + 1 < world:
                kb, vb = _hop(kb), _hop(vb)
        return torch.cat([_norm(stA[0], stA[2], q.dtype),
                          _norm(stB[0], stB[2], q.dtype)], 1)

    return body_flash if use_flash else body


def build_ulysses_attention(comm: Communicator, n_heads: int,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            use_flash: bool = False) -> Callable:
    """All-to-all (DeepSpeed-Ulysses-style) sequence parallelism: q, k, v
    (world, n, n_heads, d), sequence sharded, are resharded to head groups
    over the full sequence, attended locally (blockwise online softmax over
    n-long k blocks, or the flash kernels), and resharded back. ``n_heads``
    must be divisible by the world size; ``use_flash`` needs world n to be a
    multiple of the flash blocks (128)."""
    world = comm.world_size
    if n_heads % world != 0:
        raise ValueError(f"n_heads {n_heads} not divisible by world {world}")

    def local_attn(q, k, v, n, sc):
        H, S, d = q.shape
        dev = q.device
        qpos = torch.arange(S, device=dev)
        st = (torch.zeros((H, S, d), dtype=_F32, device=dev),
              torch.full((H, S), -_INF, dtype=_F32, device=dev),
              torch.zeros((H, S), dtype=_F32, device=dev))
        for b in range(S // n):
            kpos = torch.arange(b * n, (b + 1) * n, device=dev)
            st = _online_block(q, k[:, b * n:(b + 1) * n],
                               v[:, b * n:(b + 1) * n], *st, qpos, kpos,
                               causal, sc)
        return _norm(st[0], st[2], q.dtype)

    def body(q, k, v):
        _check(comm, world, q, k, v)
        _, n, H, d = q.shape
        if H != n_heads:
            raise ValueError(
                f"input head axis {H} != declared n_heads {n_heads}")
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        # the first all-to-all: rank r's head group over every rank's
        # sequence block, in rank order; all groups together are (H, S, d)
        qh, kh, vh = (x.permute(2, 0, 1, 3).reshape(H, world * n, d)
                      for x in (q, k, v))
        if use_flash:
            out = _flash.flash_attention(qh, kh, vh, causal=causal, scale=sc)
        else:
            out = local_attn(qh, kh, vh, n, sc)
        # the inverse: sequence blocks back to their ranks, heads in order
        return out.reshape(H, world, n, d).permute(1, 2, 0, 3).contiguous()

    return body
