"""Flash attention, the training arm (counterpart: ``accl_tpu/ops/flash.py``
``flash_attention``, ``flash_attention_lse`` and the kernels and policies
under them): blockwise softmax attention whose (S, S) score matrix never
exists, forward and backward.

Layouts are the JAX package's: q (H, S, d) or (S, d), promoted; k and v
(H_kv, S, d) with ``H % H_kv == 0`` (grouped-query attention: q head h reads
kv head ``h // (H / H_kv)``, no repeat is materialized); any head dim on the
CPU. ``flash_attention_lse`` also returns the per-row log-sum-exp, (H, S),
natural log (the TPU's (H, nq, pad_rows, 128) slab is TPU tiling and is not
carried over).

Four kernels, each with a plain PyTorch version, a launch counter and a
wrapper that runs the plain version on CPU tensors and launches the CUDA
kernel on CUDA tensors (or raises; there is no fallback):

* :func:`flash_fwd` replaces ``flash.py:_kernel`` (row 21): the online
  softmax in the exp2 domain, out and lse. Kernel:
  ``csrc/flash.cu:flash_fwd_kernel``.
* :func:`flash_bwd_fused` replaces ``flash.py:_bwd_fused_kernel`` (row 22):
  P and dS recomputed once per live tile, dQ, dK and dV from one sweep.
  Kernel: ``csrc/flash.cu:flash_bwd_fused_kernel`` and its fixed-order dQ
  pass ``flash_dq_reduce_kernel``.
* :func:`flash_bwd_kv` replaces ``flash.py:_bwd_kv_kernel`` (row 23), the
  two-pass backward's dK/dV. Kernel: ``csrc/flash.cu:flash_bwd_kv_kernel``.
* :func:`flash_bwd_q` replaces ``flash.py:_bwd_q_kernel`` (row 24), the
  two-pass backward's dQ. Kernel: ``csrc/flash.cu:flash_bwd_q_kernel``.

The head-packed d=64 arm, :func:`flash_attention_packed`, pairs heads 2p
and 2p + 1 on the two 64-lane halves of a 128-wide row (q, k and v packed
(H/2, S, 128), lse and dd (H/2, 2, S)) and runs four kernels of its own,
one block carrying both heads of a pair, each head with its own m, l and
accumulators:

* :func:`flash_fwd_packed` replaces ``flash.py:_kernel_packed`` (row 25).
  Kernel: ``csrc/flash.cu:flash_fwd_packed_kernel``.
* :func:`flash_bwd_fused_packed` replaces
  ``flash.py:_bwd_fused_kernel_packed`` (row 26). Kernel:
  ``csrc/flash.cu:flash_bwd_fused_packed_kernel``, with
  ``flash_dq_reduce_kernel`` over the packed slab.
* :func:`flash_bwd_kv_packed` replaces ``flash.py:_bwd_kv_kernel_packed``
  (row 27). Kernel: ``csrc/flash.cu:flash_bwd_kv_packed_kernel``.
* :func:`flash_bwd_q_packed` replaces ``flash.py:_bwd_q_kernel_packed``
  (row 28). Kernel: ``csrc/flash.cu:flash_bwd_q_packed_kernel``.

Each head of a pair runs the general kernels' arithmetic, so the packed
arm gives the general arm's bits at d 64, on the CPU and on the card.

The plain versions follow the TPU kernels' arithmetic block by block: scores
scaled by ``scale * log2(e)`` and exponentiated with exp2, the -1e30
sentinel, the ``safe_l`` guard, the causal dead-block test on element ranges
(``j * block_k < (i + 1) * block_q``), ``p`` cast to v's dtype before P·V in
the forward, do, q and k promoted to f32 and p and dS kept in f32 in the
backward, dK/dV summed over (q head in group, q block, 128-row strip)
ascending and dQ over k blocks ascending. On the CPU the blocks are the JAX
package's interpret geometry, (128, 128) unless the caller names others;
the card's kernels tile by 64 rows and 64 columns whatever the blocks
(``csrc/flash.cu``). Policy is the JAX package's number for number:
``_default_blocks`` and ``_bwd_default_blocks`` at hardware geometry decide
the shape checks and whether the fused backward or the two-pass pair runs
on the card exactly as they do on a TPU (``None``: two-pass).

The backward mode register (``ACCLConfig.flash_bwd``, written through by
``ACCL.config``) is :func:`set_flash_bwd_mode`; ``bwd_mode`` overrides it
per call.

The serving arm (``flash.py:1347-2300``): the decode, prefill, KV-codec
and quantization-scale registers (``ACCLConfig.flash_decode``,
``flash_prefill``, ``kv_cache_dtype``, ``kv_quant_scale``), the codecs
(:func:`quantize_kv`, :func:`dequantize_kv`, :func:`quantize_kv_paged`),
the plans (:func:`decode_plan`, :func:`prefill_plan`, the JAX package's
numbers and 12 MiB budget), the cache writes (:func:`kv_cache_append`,
:func:`kv_cache_append_multi`, in place) and the entry points
:func:`flash_decode` and :func:`flash_prefill`, over two kernels with one
plain version, :func:`plain_paged_decode`:

* :func:`paged_decode` replaces ``flash.py:_decode_kernel`` (row 29), one
  query row per GQA head of each slot. Kernel:
  ``csrc/decode.cu:flash_decode_kernel``.
* :func:`paged_decode_span` replaces ``flash.py:_decode_span_kernel`` (row
  30), span rows per head with per-row causal horizons (a prefill chunk).
  Kernel: ``csrc/decode.cu:flash_decode_span_kernel``.

Where a plan declines, or in mode "unpaged", the gathered-chain reference
runs, counted per reason. The speculative and handoff helpers are not
ported yet (``ROADMAP.md`` item 14).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import cuda_build

_F32 = torch.float32
_NEG_INF = -1e30  # finite sentinel: keeps exp2() exact-zero without nan paths
_LOG2E = 1.4426950408889634   # the online softmax runs in the exp2 domain;
_LN2 = 0.6931471805599453     # lse is stored as a natural log
#: the JAX package's scoped-VMEM budget for the block policies (a TPU's
#: 16 MiB less Mosaic's margin). The card's kernels do not need it; the
#: policies keep it so that they decide what the JAX package decides.
_VMEM_BUDGET = 12 << 20
#: rows of the TPU backward kernels' strips (their sweep unit in a q block)
_STRIP = 128
#: the card kernels' tile rows and columns (``csrc/flash.cu``: BQ, BK)
_CARD_TILE = 64
#: the largest head dim the card kernels take (their tiles are staged as f32
#: in shared memory, 64 rows of up to 128 columns)
_CARD_MAX_D = 128
#: bytes of f32 dQ partials one fused-backward launch may stage (its k tiles
#: times H x S x d x 4 B); a longer sweep runs as several launches, each
#: followed by its fixed-order dQ pass
_DQ_SLAB_BUDGET = 4 << 30


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# block policies (``accl_tpu/ops/flash.py:169-350``)
# ---------------------------------------------------------------------------

def _auto_block(S: int, causal: bool, dp: int = 128) -> int:
    """Largest 128-multiple power-of-two block dividing S, capped at 256
    causal and 1024 otherwise and by the VMEM estimate of two f32 score
    blocks and eight q/k/v/out/acc strips at the padded head dim ``dp``."""
    cap = 256 if causal else 1024

    def vmem_est(b: int) -> int:
        return 2 * b * b * 4 + 8 * b * dp * 4

    b = 128
    while b * 2 <= cap and S % (b * 2) == 0 \
            and vmem_est(b * 2) <= _VMEM_BUDGET:
        b *= 2
    return b if S % b == 0 else 128


def _single_k_bq(S: int, dp: int, itemsize: int) -> int:
    """Largest 128-multiple q block <= 512 dividing S whose single-k-block
    footprint fits the VMEM budget, else 0."""
    for bq in (512, 384, 256, 128):
        if S % bq:
            continue
        est = (bq * S * (4 + itemsize) + 4 * S * dp * itemsize
               + 24 * bq * dp)
        if est <= _VMEM_BUDGET:
            return bq
    return 0


def _default_blocks(S: int, d: int, causal: bool,
                    block_q: Optional[int], block_k: Optional[int],
                    itemsize: int = 2, cpu: bool = False):
    """The forward's (block_q, block_k): the caller's where given, else the
    JAX package's hardware policy (single k block up to S 2048, asymmetric
    causal sweeps, the auto sizes). ``cpu``: the interpret geometry, 128
    for every block the caller leaves open."""
    if cpu:
        return block_q or 128, block_k or 128
    dp_est = -(-d // 128) * 128
    if block_q is None and block_k is None and S <= 2048 and S % 128 == 0:
        bq = _single_k_bq(S, dp_est, itemsize)
        if bq:
            return bq, S
    if causal and block_q is None and block_k is None:
        for bq in (512, 384, 256, 128):
            if S % bq:
                continue
            for bk in (1024, 512, 384, 256, 128):
                if S % bk:
                    continue
                if 8 * bq * bk + 16 * (bq + bk) * dp_est <= _VMEM_BUDGET:
                    return bq, bk
        return 128, 128
    if block_q is None:
        block_q = _auto_block(S, causal, dp_est)
    if block_k is None:
        block_k = _auto_block(S, causal, dp_est)
    return block_q, block_k


_BWD_MODES = ("fused", "two_pass")
_BWD_MODE = "fused"


def set_flash_bwd_mode(mode: str) -> None:
    """Set the module-default backward mode (``ACCLConfig.flash_bwd`` lands
    here). Per-call override: the entry points' ``bwd_mode``."""
    global _BWD_MODE
    if mode not in _BWD_MODES:
        raise ValueError(f"flash_bwd mode {mode!r} not in {_BWD_MODES}")
    _BWD_MODE = mode


def get_flash_bwd_mode() -> str:
    return _BWD_MODE


def _resolve_bwd(bwd_mode: Optional[str]) -> str:
    """An explicit per-call ``bwd_mode`` wins, else the module default."""
    bwd = bwd_mode or _BWD_MODE
    if bwd not in _BWD_MODES:
        raise ValueError(f"bwd_mode {bwd!r} not in {_BWD_MODES}")
    return bwd


def _bwd_vmem_est(S: int, dp: int, bq: int, bk: int, itemsize: int) -> int:
    """The TPU fused backward's VMEM plan at (bq, bk): the two (S, dp) f32
    dK/dV planes, double-buffered k/v and q/do strips, the dq output and
    its scratch, and the strip temporaries."""
    plane = 2 * S * dp * 4
    kv = 4 * bk * dp * itemsize
    qdo = 4 * bq * dp * itemsize
    dq = 3 * bq * dp * 4
    tiles = 4 * 128 * bk * 4
    return plane + kv + qdo + dq + tiles


def _bwd_default_blocks(S: int, dp: int, causal: bool, itemsize: int = 2,
                        cpu: bool = False) -> Optional[Tuple[int, int]]:
    """The fused backward's (block_q, block_k), or None where no geometry
    fits the VMEM budget: the two-pass pair then runs at the forward's
    blocks. ``dp`` is the padded head dim. ``cpu``: (128, 128)."""
    if cpu:
        return 128, 128
    if S % 128:
        return None

    def fits(bq: int, bk: int) -> bool:
        return _bwd_vmem_est(S, dp, bq, bk, itemsize) <= _VMEM_BUDGET

    if S <= 2048:
        for bq in (512, 384, 256, 128):
            if S % bq == 0 and fits(bq, S):
                return bq, S
    for bq in ((512, 384, 256, 128) if causal
               else (1024, 512, 384, 256, 128)):
        if S % bq:
            continue
        for bk in (1024, 512, 384, 256, 128):
            if S % bk:
                continue
            if fits(bq, bk):
                return bq, bk
    return None


def _check_shapes(q, k, v, S, d, block_q, block_k):
    if S % block_q or S % block_k or block_q % 128:
        raise ValueError(
            f"flash_attention needs S % block ({S} % {block_q}/{block_k}) "
            f"== 0 and block_q % 128 == 0 ({block_q})")
    if k.shape != v.shape or tuple(k.shape[1:]) != (S, d) \
            or q.shape[0] % k.shape[0]:
        raise ValueError(
            f"k/v shape {tuple(k.shape)} incompatible with q "
            f"{tuple(q.shape)}: need (H_kv, S, d) with H % H_kv == 0 "
            f"(grouped-query attention)")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def plain_flash_fwd(q, k, v, causal: bool, scale: float, block_q: int = 128,
                    block_k: int = 128):
    """(out, lse) of the forward kernel: out (H, S, d) in q's dtype, lse
    (H, S) f32 natural log. One online-softmax step per k block, all heads
    and every live q block at once; a q block is live for k block j when
    ``j * block_k < (i + 1) * block_q`` (causal), and only its rows step."""
    H, S, d = q.shape
    hkv = k.shape[0]
    g = H // hkv
    c = scale * _LOG2E
    qg = q.reshape(hkv, g, S, d).float()
    acc = torch.zeros((hkv, g, S, d), dtype=_F32, device=q.device)
    m = torch.full((hkv, g, S, 1), _NEG_INF, dtype=_F32, device=q.device)
    l = torch.zeros((hkv, g, S, 1), dtype=_F32, device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for j in range(S // block_k):
        c0 = j * block_k
        r0 = (c0 // block_q) * block_q if causal else 0
        kb = k[:, None, c0:c0 + block_k].float()
        vb = v[:, None, c0:c0 + block_k]
        s = torch.matmul(qg[:, :, r0:], kb.transpose(-1, -2)) * c
        if causal:
            cols = torch.arange(c0, c0 + block_k, device=q.device)[None, :]
            s = torch.where(rows[r0:] >= cols, s, _NEG_INF)
        m_prev = m[:, :, r0:]
        m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m_prev - m_new)
        l[:, :, r0:] = l[:, :, r0:] * alpha + p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vb.float())
        acc[:, :, r0:] = acc[:, :, r0:] * alpha + pv
        m[:, :, r0:] = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    out = (acc / safe_l).to(q.dtype).reshape(H, S, d)
    lse = (m * _LN2 + torch.log(safe_l)).reshape(H, S)
    return out, lse


def _recompute_p_ds(qs, kb, vb, dos, lse2, dd, row0: int, col0: int,
                    causal: bool, sc: float):
    """p and dS of one (strip, k block) tile, vectorized over kv heads: qs,
    dos (hkv, rows, d) f32; kb, vb (hkv, bk, d) f32; lse2 = lse * log2(e)
    and dd (hkv, rows, 1). ``row0``/``col0`` are element offsets."""
    s = torch.matmul(qs, kb.transpose(-1, -2)) * (sc * _LOG2E)
    if causal:
        rows = torch.arange(row0, row0 + s.shape[1], device=s.device)
        cols = torch.arange(col0, col0 + s.shape[2], device=s.device)
        s = torch.where(rows[:, None] >= cols[None, :], s, _NEG_INF)
    p = torch.exp2(s - lse2)
    dp = torch.matmul(dos, vb.transpose(-1, -2))
    ds = p * (dp - dd) * sc
    return p, ds


def _plain_bwd(q, k, v, do, lse, dd, causal: bool, sc: float, block_q: int,
               block_k: int, want_dq: bool, want_dkv: bool):
    """The backward kernels' sums in their order: for each k block j, each
    q head of the group, each live q block i and each 128-row strip of it,
    p and dS once; dV += pᵀ dO and dK += dSᵀ Q into the k block's rows (so
    they sum t = (head, block, strip) ascending), dQ += dS K into the
    strip's rows (so each dQ row sums j ascending). All f32."""
    H, S, d = q.shape
    hkv = k.shape[0]
    g = H // hkv
    dev = q.device
    qg = q.reshape(hkv, g, S, d).float()
    dog = do.reshape(hkv, g, S, d).float()
    lse2 = (lse.float() * _LOG2E).reshape(hkv, g, S, 1)
    ddg = dd.float().reshape(hkv, g, S, 1)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((hkv, g, S, d), dtype=_F32, device=dev) \
        if want_dq else None
    dk = torch.zeros((hkv, S, d), dtype=_F32, device=dev) \
        if want_dkv else None
    dv = torch.zeros((hkv, S, d), dtype=_F32, device=dev) \
        if want_dkv else None
    strip = min(_STRIP, block_q)
    for j in range(S // block_k):
        c0 = j * block_k
        kb, vb = kf[:, c0:c0 + block_k], vf[:, c0:c0 + block_k]
        for gi in range(g):
            for i in range(S // block_q):
                if causal and not c0 < (i + 1) * block_q:
                    continue
                for r0 in range(i * block_q, (i + 1) * block_q, strip):
                    rs = slice(r0, r0 + strip)
                    qs, dos = qg[:, gi, rs], dog[:, gi, rs]
                    p, ds = _recompute_p_ds(qs, kb, vb, dos, lse2[:, gi, rs],
                                            ddg[:, gi, rs], r0, c0, causal,
                                            sc)
                    if want_dkv:
                        dv[:, c0:c0 + block_k] += torch.matmul(
                            p.transpose(-1, -2), dos)
                        dk[:, c0:c0 + block_k] += torch.matmul(
                            ds.transpose(-1, -2), qs)
                    if want_dq:
                        dq[:, gi, rs] += torch.matmul(ds, kb)
    return (dq.reshape(H, S, d) if want_dq else None), dk, dv


def plain_flash_bwd_fused(q, k, v, do, lse, dd, causal: bool, scale: float,
                          block_q: int = 128, block_k: int = 128):
    """(dq (H, S, d), dk, dv (H_kv, S, d)) f32 of the fused backward kernel,
    from lse (H, S) and the row term dd = rowsum(dO ∘ O) - dlse (H, S)."""
    return _plain_bwd(q, k, v, do, lse, dd, causal, scale, block_q, block_k,
                      True, True)


def plain_flash_bwd_kv(q, k, v, do, lse, dd, causal: bool, scale: float,
                       block_q: int = 128, block_k: int = 128):
    """(dk, dv) f32 of the two-pass backward's dK/dV kernel."""
    return _plain_bwd(q, k, v, do, lse, dd, causal, scale, block_q, block_k,
                      False, True)[1:]


def plain_flash_bwd_q(q, k, v, do, lse, dd, causal: bool, scale: float,
                      block_q: int = 128, block_k: int = 128):
    """dq f32 of the two-pass backward's dQ kernel."""
    return _plain_bwd(q, k, v, do, lse, dd, causal, scale, block_q, block_k,
                      True, False)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DT_CODE = {torch.float16: 2, torch.float32: 3, torch.bfloat16: 7}


def _card_head_dim(d: int) -> int:
    """The padded head dim the card kernels are built for (64, 96 or 128;
    a smaller d is zero-padded, which is exact); raises past 128."""
    for dp in (64, 96, 128):
        if d <= dp:
            return dp
    raise ValueError(f"the flash kernels on the card take head dims up to "
                     f"{_CARD_MAX_D}, got {d}")


def _card_operands(what: str, q, k, v, extra=()):
    """Check what the card kernels take: contiguous CUDA tensors of one
    dtype (f32, bf16 or f16), q (H, S, d) and k/v (H_kv, S, d) with
    ``H % H_kv == 0``, S a multiple of the 64-row tile, d <= 128.
    Returns (dtype code, padded head dim)."""
    for t in (q, k, v, *extra):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous on one "
                             f"device")
    if q.dtype not in _DT_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} takes q, k and v of one dtype out of f32, "
                         f"bf16 and f16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    H, S, d = q.shape
    if k.shape != v.shape or tuple(k.shape[1:]) != (S, d) \
            or H % k.shape[0]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if S % _CARD_TILE:
        raise ValueError(f"{what}: S {S} is not a multiple of "
                         f"{_CARD_TILE}")
    return _DT_CODE[q.dtype], _card_head_dim(d)


def _ptr(t: torch.Tensor) -> int:
    return int(t.data_ptr())


def _call(name: str, fn, *args, device) -> None:
    lib = cuda_build.load("flash")
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, cuda_build.stream_handle(device))
    cuda_build.check(lib, rc, name)


def flash_fwd(q, k, v, causal: bool, scale: float, block_q: int = 128,
              block_k: int = 128):
    """Kernel 21 (replaces ``flash.py:_kernel``). Same contract as
    :func:`plain_flash_fwd`; the blocks shape the plain version only (the
    card kernel tiles by 64 x 64)."""
    if q.device.type != "cuda":
        return plain_flash_fwd(q, k, v, causal, scale, block_q, block_k)
    code, dp = _card_operands("flash_fwd_kernel", q, k, v)
    H, S, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((H, S), dtype=_F32, device=q.device)
    _call("flash_fwd_kernel", "accl_flash_fwd", code, dp, _ptr(q), _ptr(k),
          _ptr(v), _ptr(out), _ptr(lse), H, k.shape[0], S, d, int(causal),
          ctypes.c_float(scale * _LOG2E), device=q.device)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _bwd_operands(what: str, q, k, v, do, lse, dd, rows=None):
    """:func:`_card_operands` and the backward's own: do like q, lse and dd
    f32 of shape ``rows``, (H, S) unless given."""
    code, dp = _card_operands(what, q, k, v, (do, lse, dd))
    rows = rows or tuple(q.shape[:2])
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("dd", dd)):
        if tuple(t.shape) != rows or t.dtype != _F32:
            raise ValueError(f"{what}: {name} must be {rows} f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return code, dp


def _slab_run(nkt: int, plane_bytes: int) -> int:
    """k tiles of one fused-backward launch: as many runs as
    ``_DQ_SLAB_BUDGET`` needs for ``nkt`` dQ planes of ``plane_bytes``, as
    even as the runs allow."""
    runs = -(-nkt // max(1, _DQ_SLAB_BUDGET // plane_bytes))
    return -(-nkt // runs)


def flash_bwd_fused(q, k, v, do, lse, dd, causal: bool, scale: float,
                    block_q: int = 128, block_k: int = 128):
    """Kernel 22 (replaces ``flash.py:_bwd_fused_kernel``). Same contract as
    :func:`plain_flash_bwd_fused`. One launch of ``flash_bwd_fused_kernel``
    per run of k tiles whose dQ partials fit ``_DQ_SLAB_BUDGET``, each
    followed by ``flash_dq_reduce_kernel``, which adds the run's partials
    into dq in ascending k-tile order; the counter counts the former."""
    if q.device.type != "cuda":
        return plain_flash_bwd_fused(q, k, v, do, lse, dd, causal, scale,
                                     block_q, block_k)
    code, dp = _bwd_operands("flash_bwd_fused_kernel", q, k, v, do, lse, dd)
    H, S, d = q.shape
    hkv = k.shape[0]
    dq = torch.zeros((H, S, d), dtype=_F32, device=q.device)
    dk = torch.empty((hkv, S, d), dtype=_F32, device=q.device)
    dv = torch.empty((hkv, S, d), dtype=_F32, device=q.device)
    nkt = S // _CARD_TILE
    run = _slab_run(nkt, H * S * d * 4)
    slab = torch.empty((run, H, S, d), dtype=_F32, device=q.device)
    for kt0 in range(0, nkt, run):
        kt1 = min(nkt, kt0 + run)
        _call("flash_bwd_fused_kernel", "accl_flash_bwd_fused", code, dp,
              _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd),
              _ptr(dk), _ptr(dv), _ptr(slab), H, hkv, S, d, int(causal),
              ctypes.c_float(scale * _LOG2E), ctypes.c_float(scale), kt0,
              kt1, device=q.device)
        flash_bwd_fused.launches += 1
        _call("flash_dq_reduce_kernel", "accl_flash_dq_reduce", _ptr(dq),
              _ptr(slab), H, S, d, int(causal), kt0, kt1, device=q.device)
    return dq, dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_kv(q, k, v, do, lse, dd, causal: bool, scale: float,
                 block_q: int = 128, block_k: int = 128):
    """Kernel 23 (replaces ``flash.py:_bwd_kv_kernel``). Same contract as
    :func:`plain_flash_bwd_kv`."""
    if q.device.type != "cuda":
        return plain_flash_bwd_kv(q, k, v, do, lse, dd, causal, scale,
                                  block_q, block_k)
    code, dp = _bwd_operands("flash_bwd_kv_kernel", q, k, v, do, lse, dd)
    H, S, d = q.shape
    hkv = k.shape[0]
    dk = torch.empty((hkv, S, d), dtype=_F32, device=q.device)
    dv = torch.empty((hkv, S, d), dtype=_F32, device=q.device)
    _call("flash_bwd_kv_kernel", "accl_flash_bwd_kv", code, dp, _ptr(q),
          _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(dk),
          _ptr(dv), H, hkv, S, d, int(causal),
          ctypes.c_float(scale * _LOG2E), ctypes.c_float(scale),
          device=q.device)
    flash_bwd_kv.launches += 1
    return dk, dv


flash_bwd_kv.launches = 0


def flash_bwd_q(q, k, v, do, lse, dd, causal: bool, scale: float,
                block_q: int = 128, block_k: int = 128):
    """Kernel 24 (replaces ``flash.py:_bwd_q_kernel``). Same contract as
    :func:`plain_flash_bwd_q`."""
    if q.device.type != "cuda":
        return plain_flash_bwd_q(q, k, v, do, lse, dd, causal, scale,
                                 block_q, block_k)
    code, dp = _bwd_operands("flash_bwd_q_kernel", q, k, v, do, lse, dd)
    H, S, d = q.shape
    dq = torch.empty((H, S, d), dtype=_F32, device=q.device)
    _call("flash_bwd_q_kernel", "accl_flash_bwd_q", code, dp, _ptr(q),
          _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(dq), H,
          k.shape[0], S, d, int(causal), ctypes.c_float(scale * _LOG2E),
          ctypes.c_float(scale), device=q.device)
    flash_bwd_q.launches += 1
    return dq


flash_bwd_q.launches = 0


# ---------------------------------------------------------------------------
# autograd and entry points
# ---------------------------------------------------------------------------

def _bwd_from_dd(q, k, v, do, lse, dd, causal, sc, block_q, block_k, bwd,
                 kernels=None):
    """The shared backward: ``dd`` (H, S) is rowsum(dO ∘ O), less dlse when
    lse has a cotangent. Mode "fused" runs the fused kernel where the JAX
    backward policy finds a geometry; otherwise, or in mode "two_pass", the
    dK/dV and dQ pair runs at the forward's blocks. ``kernels``: the
    (fused, dK/dV, dQ) wrappers, the general ones by default; the packed
    arm passes its own, whose q is (H/2, S, 128), so the policy sees the
    packed tile's 128 lanes as the JAX packed backward does."""
    fused, bwd_kv, bwd_q = kernels or (flash_bwd_fused, flash_bwd_kv,
                                       flash_bwd_q)
    H, S, d = q.shape
    cpu = q.device.type != "cuda"
    if bwd == "fused":
        dp = -(-d // 128) * 128
        blocks = _bwd_default_blocks(S, dp, causal, _itemsize(q.dtype), cpu)
        if blocks is not None:
            dq, dk, dv = fused(q, k, v, do, lse, dd, causal, sc, *blocks)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    dk, dv = bwd_kv(q, k, v, do, lse, dd, causal, sc, block_q, block_k)
    dq = bwd_q(q, k, v, do, lse, dd, causal, sc, block_q, block_k)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """The forward and backward of both entry points (the JAX custom VJPs
    ``_flash`` and ``_flash_lse``): the forward saves q, k, v, out and lse;
    the backward computes D = rowsum(dO ∘ O), less lse's cotangent where it
    has one, in plain torch, and runs the fused kernel or the two-pass
    pair. ``flash_attention`` drops lse, whose cotangent is then None."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sc, blocks, bwd):
        ctx.set_materialize_grads(False)
        out, lse = flash_fwd(q, k, v, causal, sc, *blocks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, sc, *blocks, bwd)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        do = do.to(q.dtype).contiguous()
        dd = (do.float() * out.float()).sum(-1)
        if dlse is not None:
            dd = dd - dlse.float()
        grads = _bwd_from_dd(q, k, v, do, lse, dd.contiguous(), *ctx.opts)
        return (*grads, None, None, None, None)


def _prepare(q, k, v, causal, scale, block_q, block_k, bwd_mode):
    bwd = _resolve_bwd(bwd_mode)
    single = q.dim() == 2
    if single:
        q, k, v = q[None], k[None], v[None]
    H, S, d = q.shape
    blocks = _default_blocks(S, d, causal, block_q, block_k,
                             _itemsize(q.dtype), q.device.type != "cuda")
    _check_shapes(q, k, v, S, d, *blocks)
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    return (q.contiguous(), k.contiguous(), v.contiguous(), causal, sc,
            blocks, bwd), single


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    bwd_mode: Optional[str] = None):
    """Fused blockwise attention: q (H, S, d) or (S, d); k/v (H_kv, S, d)
    with ``H % H_kv == 0``. S must divide by the blocks, block_q by 128.
    Differentiable: the backward runs the fused kernel, or the two-pass pair
    where the backward policy finds no fused geometry or with
    ``bwd_mode="two_pass"`` (default: ``ACCLConfig.flash_bwd``)."""
    args, single = _prepare(q, k, v, causal, scale, block_q, block_k,
                            bwd_mode)
    out = _Flash.apply(*args)[0]
    return out[0] if single else out


def flash_attention_lse(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        bwd_mode: Optional[str] = None):
    """Like :func:`flash_attention`, also returning the per-row log-sum-exp
    (H, S), f32, natural log: the merge key of partial attentions (ring
    attention). Differentiable in both outputs: lse's cotangent enters the
    backward as D - dlse."""
    args, single = _prepare(q, k, v, causal, scale, block_q, block_k,
                            bwd_mode)
    out, lse = _Flash.apply(*args)
    return (out[0], lse[0]) if single else (out, lse)


# ---------------------------------------------------------------------------
# the head-packed d=64 arm (``accl_tpu/ops/flash.py:830-1311``)
# ---------------------------------------------------------------------------

#: the one head dim the packed arm takes: a head pair fills a 128-wide row
_PACKED_D = 64


def _pack_heads(x):
    """(H, S, d) -> (H/2, S, 2d): heads 2p and 2p + 1 share row s of pair
    p, ``packed[p, s, h d + c] = x[2p + h, s, c]``. A relayout of the same
    bytes (a copy), not a pad."""
    H, S, d = x.shape
    return x.reshape(H // 2, 2, S, d).transpose(1, 2).reshape(H // 2, S,
                                                              2 * d)


def _unpack_heads(x):
    """Inverse of :func:`_pack_heads`."""
    H2, S, d2 = x.shape
    return x.reshape(H2, S, 2, d2 // 2).transpose(1, 2).reshape(
        2 * H2, S, d2 // 2)


def plain_flash_fwd_packed(q, k, v, causal: bool, scale: float,
                           block_q: int = 128, block_k: int = 128):
    """(out (H2, S, 128) in q's dtype, lse (H2, 2, S) f32 natural log) of
    the packed forward kernel, on packed q, k and v (H2, S, 128): lane half
    h of pair p is head 2p + h, whose online softmax is
    :func:`plain_flash_fwd`'s (the TPU kernel runs the general kernel's
    step on each half, with its own m and l)."""
    H2, S, _ = q.shape
    out, lse = plain_flash_fwd(_unpack_heads(q), _unpack_heads(k),
                               _unpack_heads(v), causal, scale, block_q,
                               block_k)
    return _pack_heads(out), lse.reshape(H2, 2, S)


def _plain_bwd_packed(q, k, v, do, lse, dd, causal: bool, sc: float,
                      block_q: int, block_k: int, want_dq: bool,
                      want_dkv: bool):
    """:func:`_plain_bwd` per lane half (g = 1) on packed operands; lse and
    dd (H2, 2, S), the gradients packed (H2, S, 128) f32."""
    H2, S, _ = q.shape
    grads = _plain_bwd(*(_unpack_heads(t) for t in (q, k, v, do)),
                       lse.reshape(2 * H2, S), dd.reshape(2 * H2, S), causal,
                       sc, block_q, block_k, want_dq, want_dkv)
    return tuple(None if t is None else _pack_heads(t) for t in grads)


def plain_flash_bwd_fused_packed(q, k, v, do, lse, dd, causal: bool,
                                 scale: float, block_q: int = 128,
                                 block_k: int = 128):
    """(dq, dk, dv) (H2, S, 128) f32 of the packed fused backward kernel,
    from lse and the per-half row term dd = rowsum(dO ∘ O), (H2, 2, S)."""
    return _plain_bwd_packed(q, k, v, do, lse, dd, causal, scale, block_q,
                             block_k, True, True)


def plain_flash_bwd_kv_packed(q, k, v, do, lse, dd, causal: bool,
                              scale: float, block_q: int = 128,
                              block_k: int = 128):
    """(dk, dv) f32 of the packed two-pass backward's dK/dV kernel."""
    return _plain_bwd_packed(q, k, v, do, lse, dd, causal, scale, block_q,
                             block_k, False, True)[1:]


def plain_flash_bwd_q_packed(q, k, v, do, lse, dd, causal: bool,
                             scale: float, block_q: int = 128,
                             block_k: int = 128):
    """dq f32 of the packed two-pass backward's dQ kernel."""
    return _plain_bwd_packed(q, k, v, do, lse, dd, causal, scale, block_q,
                             block_k, True, False)[0]


def _packed_operands(what: str, q, k, v):
    """What the packed kernels take: :func:`_card_operands`'s operands with
    q, k and v all (H2, S, 128). Returns the dtype code."""
    code, _ = _card_operands(what, q, k, v)
    if q.shape[2] != 2 * _PACKED_D or k.shape[0] != q.shape[0]:
        raise ValueError(f"{what} takes packed q, k and v (H2, S, "
                         f"{2 * _PACKED_D}), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return code


def _packed_bwd_operands(what: str, q, k, v, do, lse, dd):
    code = _packed_operands(what, q, k, v)
    _bwd_operands(what, q, k, v, do, lse, dd, (q.shape[0], 2, q.shape[1]))
    return code


def flash_fwd_packed(q, k, v, causal: bool, scale: float, block_q: int = 128,
                     block_k: int = 128):
    """Kernel 25 (replaces ``flash.py:_kernel_packed``). Same contract as
    :func:`plain_flash_fwd_packed`; the blocks shape the plain version
    only."""
    if q.device.type != "cuda":
        return plain_flash_fwd_packed(q, k, v, causal, scale, block_q,
                                      block_k)
    code = _packed_operands("flash_fwd_packed_kernel", q, k, v)
    H2, S, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((H2, 2, S), dtype=_F32, device=q.device)
    _call("flash_fwd_packed_kernel", "accl_flash_fwd_packed", code, _ptr(q),
          _ptr(k), _ptr(v), _ptr(out), _ptr(lse), H2, S, int(causal),
          ctypes.c_float(scale * _LOG2E), device=q.device)
    flash_fwd_packed.launches += 1
    return out, lse


flash_fwd_packed.launches = 0


def flash_bwd_fused_packed(q, k, v, do, lse, dd, causal: bool, scale: float,
                           block_q: int = 128, block_k: int = 128):
    """Kernel 26 (replaces ``flash.py:_bwd_fused_kernel_packed``). Same
    contract as :func:`plain_flash_bwd_fused_packed`. As
    :func:`flash_bwd_fused`: one launch of ``flash_bwd_fused_packed_kernel``
    per run of k tiles whose packed dQ partials fit ``_DQ_SLAB_BUDGET``,
    each followed by ``flash_dq_reduce_kernel`` over the slab viewed as
    (H2, S, 128); the counter counts the former."""
    if q.device.type != "cuda":
        return plain_flash_bwd_fused_packed(q, k, v, do, lse, dd, causal,
                                            scale, block_q, block_k)
    code = _packed_bwd_operands("flash_bwd_fused_packed_kernel", q, k, v, do,
                                lse, dd)
    H2, S, d2 = q.shape
    dq = torch.zeros((H2, S, d2), dtype=_F32, device=q.device)
    dk = torch.empty((H2, S, d2), dtype=_F32, device=q.device)
    dv = torch.empty((H2, S, d2), dtype=_F32, device=q.device)
    nkt = S // _CARD_TILE
    run = _slab_run(nkt, H2 * S * d2 * 4)
    slab = torch.empty((run, H2, S, d2), dtype=_F32, device=q.device)
    for kt0 in range(0, nkt, run):
        kt1 = min(nkt, kt0 + run)
        _call("flash_bwd_fused_packed_kernel", "accl_flash_bwd_fused_packed",
              code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd),
              _ptr(dk), _ptr(dv), _ptr(slab), H2, S, int(causal),
              ctypes.c_float(scale * _LOG2E), ctypes.c_float(scale), kt0,
              kt1, device=q.device)
        flash_bwd_fused_packed.launches += 1
        _call("flash_dq_reduce_kernel", "accl_flash_dq_reduce", _ptr(dq),
              _ptr(slab), H2, S, d2, int(causal), kt0, kt1, device=q.device)
    return dq, dk, dv


flash_bwd_fused_packed.launches = 0


def flash_bwd_kv_packed(q, k, v, do, lse, dd, causal: bool, scale: float,
                        block_q: int = 128, block_k: int = 128):
    """Kernel 27 (replaces ``flash.py:_bwd_kv_kernel_packed``). Same
    contract as :func:`plain_flash_bwd_kv_packed`."""
    if q.device.type != "cuda":
        return plain_flash_bwd_kv_packed(q, k, v, do, lse, dd, causal, scale,
                                         block_q, block_k)
    code = _packed_bwd_operands("flash_bwd_kv_packed_kernel", q, k, v, do,
                                lse, dd)
    H2, S, d2 = q.shape
    dk = torch.empty((H2, S, d2), dtype=_F32, device=q.device)
    dv = torch.empty((H2, S, d2), dtype=_F32, device=q.device)
    _call("flash_bwd_kv_packed_kernel", "accl_flash_bwd_kv_packed", code,
          _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(dk),
          _ptr(dv), H2, S, int(causal), ctypes.c_float(scale * _LOG2E),
          ctypes.c_float(scale), device=q.device)
    flash_bwd_kv_packed.launches += 1
    return dk, dv


flash_bwd_kv_packed.launches = 0


def flash_bwd_q_packed(q, k, v, do, lse, dd, causal: bool, scale: float,
                       block_q: int = 128, block_k: int = 128):
    """Kernel 28 (replaces ``flash.py:_bwd_q_kernel_packed``). Same
    contract as :func:`plain_flash_bwd_q_packed`."""
    if q.device.type != "cuda":
        return plain_flash_bwd_q_packed(q, k, v, do, lse, dd, causal, scale,
                                        block_q, block_k)
    code = _packed_bwd_operands("flash_bwd_q_packed_kernel", q, k, v, do,
                                lse, dd)
    H2, S, d2 = q.shape
    dq = torch.empty((H2, S, d2), dtype=_F32, device=q.device)
    _call("flash_bwd_q_packed_kernel", "accl_flash_bwd_q_packed", code,
          _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(dq),
          H2, S, int(causal), ctypes.c_float(scale * _LOG2E),
          ctypes.c_float(scale), device=q.device)
    flash_bwd_q_packed.launches += 1
    return dq


flash_bwd_q_packed.launches = 0

_PACKED_KERNELS = (flash_bwd_fused_packed, flash_bwd_kv_packed,
                   flash_bwd_q_packed)


class _FlashPacked(torch.autograd.Function):
    """The packed arm's forward and backward (the JAX custom VJP
    ``_flash_packed``) on packed q, k and v (H2, S, 128): the forward saves
    q, k, v, out and lse (H2, 2, S); the backward takes dd as the row sum of
    dO ∘ O over each lane half on its own (one head each), as the JAX
    backward does, and runs the packed fused kernel or the packed two-pass
    pair under the JAX policy at the packed tile's 128 lanes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sc, blocks, bwd):
        out, lse = flash_fwd_packed(q, k, v, causal, sc, *blocks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, sc, *blocks, bwd)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        H2, S, d2 = q.shape
        dd = (do.float() * out.float()).reshape(H2, S, 2, d2 // 2).sum(-1)
        grads = _bwd_from_dd(q, k, v, do, lse, dd.transpose(1, 2).contiguous(),
                             *ctx.opts, kernels=_PACKED_KERNELS)
        return (*grads, None, None, None, None)


def _packed_blocks(S: int, causal: bool, block_q: Optional[int],
                   block_k: Optional[int], itemsize: int, cpu: bool):
    """The packed forward's (block_q, block_k): the JAX packed entry's
    ``_default_blocks`` at the packed tile's width, 2d = 128."""
    return _default_blocks(S, 2 * _PACKED_D, causal, block_q, block_k,
                           itemsize, cpu)


def flash_attention_packed(q, k, v, causal: bool = False,
                           scale: Optional[float] = None,
                           block_q: Optional[int] = None,
                           block_k: Optional[int] = None,
                           bwd_mode: Optional[str] = None):
    """Head-packed flash attention for d == 64 exactly: heads 2p and 2p + 1
    share a 128-wide row of pair p (:func:`_pack_heads`), and kernels 25-28
    run both heads of a pair in one block. Same semantics and gradients as
    :func:`flash_attention`. Outside the JAX package's envelope (q not (H,
    S, d), an odd H, d != 64, or grouped-query k/v) it returns
    :func:`flash_attention`, as the JAX entry does."""
    if (q.dim() != 3 or q.shape[0] % 2 or q.shape[-1] != _PACKED_D
            or k.shape[0] != q.shape[0]):
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k,
                               bwd_mode=bwd_mode)
    bwd = _resolve_bwd(bwd_mode)
    H, S, d = q.shape
    blocks = _packed_blocks(S, causal, block_q, block_k, _itemsize(q.dtype),
                            q.device.type != "cuda")
    _check_shapes(q, k, v, S, d, *blocks)
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    out = _FlashPacked.apply(_pack_heads(q), _pack_heads(k), _pack_heads(v),
                             causal, sc, blocks, bwd)
    return _unpack_heads(out)


# ---------------------------------------------------------------------------
# the serving arm: decode and prefill registers, the KV-at-rest codecs
# (``accl_tpu/ops/flash.py:1347-1537``)
# ---------------------------------------------------------------------------

#: decode-path mode (``ACCLConfig.flash_decode``): "paged" runs the paged
#: kernel wherever ``decode_plan`` admits it, "unpaged" pins the gathered-
#: chain reference
_DECODE_MODES = ("paged", "unpaged")
_DECODE_MODE = "paged"
#: prefill-path mode (``ACCLConfig.flash_prefill``), the same contract
_PREFILL_MODES = ("paged", "unpaged")
_PREFILL_MODE = "paged"
#: KV-at-rest codec of the page pools (``ACCLConfig.kv_cache_dtype``):
#: "off" stores the model dtype, "bf16" and "bf16_sr" bfloat16 (the latter
#: written through the stochastic-rounding kernel), "int8" the fixed-scale
#: quantized lane, dequantized in the kernel's read sweep
_KV_DTYPES = ("off", "bf16", "int8", "bf16_sr")
_KV_DTYPE = "off"
#: the int8 codec's fixed scale: stored value clip(round(x * scale))
_KV_QUANT_SCALE = 32.0
#: amax floor of the per-(head, page) int8 scales (an all-zero page)
_KV_SCALE_EPS = 1e-6
#: the most pool rows of one online-softmax step of the paged kernels (the
#: card kernels' staged tile, ``csrc/decode.cu``); a longer page takes
#: several steps, where the TPU kernels take one
_PAGE_STEP = 64


def set_flash_decode_mode(mode: str) -> None:
    """The module-default decode mode (``ACCLConfig.flash_decode`` lands
    here). Per-call override: ``decode_mode``."""
    global _DECODE_MODE
    if mode not in _DECODE_MODES:
        raise ValueError(f"flash_decode mode {mode!r} not in {_DECODE_MODES}")
    _DECODE_MODE = mode


def get_flash_decode_mode() -> str:
    return _DECODE_MODE


def set_flash_prefill_mode(mode: str) -> None:
    """The module-default prefill mode (``ACCLConfig.flash_prefill`` lands
    here). Per-call override: ``prefill_mode``."""
    global _PREFILL_MODE
    if mode not in _PREFILL_MODES:
        raise ValueError(
            f"flash_prefill mode {mode!r} not in {_PREFILL_MODES}")
    _PREFILL_MODE = mode


def get_flash_prefill_mode() -> str:
    return _PREFILL_MODE


def set_kv_cache_dtype(mode: str) -> None:
    """The at-rest KV codec (``ACCLConfig.kv_cache_dtype``). Writes only:
    reads follow the pool's storage dtype."""
    global _KV_DTYPE
    if mode not in _KV_DTYPES:
        raise ValueError(f"kv_cache_dtype {mode!r} not in {_KV_DTYPES}")
    _KV_DTYPE = mode


def get_kv_cache_dtype() -> str:
    return _KV_DTYPE


def set_kv_quant_scale(scale: float) -> None:
    """The int8 codec's fixed scale (``ACCLConfig.kv_quant_scale``); must be
    positive."""
    global _KV_QUANT_SCALE
    if not scale > 0:
        raise ValueError(f"kv_quant_scale must be > 0, got {scale}")
    _KV_QUANT_SCALE = float(scale)


def get_kv_quant_scale() -> float:
    return _KV_QUANT_SCALE


def kv_storage_dtype(compute_dtype, mode: Optional[str] = None):
    """The page pools' at-rest dtype under codec ``mode`` (None: the
    register)."""
    mode = mode or _KV_DTYPE
    if mode not in _KV_DTYPES:
        raise ValueError(f"kv_cache_dtype {mode!r} not in {_KV_DTYPES}")
    if mode == "off":
        return compute_dtype
    if mode == "int8":
        return torch.int8
    return torch.bfloat16


def quantize_kv(x, pool_dtype, mode: Optional[str] = None, seed=None):
    """New K/V rows in the pool's at-rest dtype: int8 pools quantize with
    the fixed scale, float pools cast; ``mode`` "bf16_sr" (None: the
    register) rounds f32 into a bf16 pool stochastically, through
    ``compression.pallas_compress_stochastic`` (row 3), seeded by default
    with the wrapping int32 sum of the rows' f32 bits, so that every token
    draws a fresh stream."""
    mode = mode or _KV_DTYPE
    if pool_dtype == torch.int8:
        s = x.float() * _KV_QUANT_SCALE
        return torch.clamp(torch.round(s), -127, 127).to(torch.int8)
    if (mode == "bf16_sr" and pool_dtype == torch.bfloat16
            and x.dtype == _F32):
        from . import compression
        x = x.contiguous()
        if seed is None:
            seed = compression.payload_seed_base(x.reshape(1, -1))
        return compression.pallas_compress_stochastic(x, torch.bfloat16,
                                                      seed)
    return x.to(pool_dtype)


def dequantize_kv(pages, compute_dtype=_F32, scales=None):
    """The inverse of :func:`quantize_kv` for the reference reads: int8
    pools divide the fixed scale (or, with ``scales`` (H_kv, n_pages) from
    :func:`quantize_kv_paged`, each page's own scale) back out; float pools
    widen."""
    if pages.dtype == torch.int8:
        if scales is not None:
            return pages.to(compute_dtype) / scales[:, :, None, None]
        return pages.to(compute_dtype) / _KV_QUANT_SCALE
    return pages.to(compute_dtype)


def quantize_kv_paged(x, mode: Optional[str] = None):
    """A whole pool ``x`` (H_kv, n_pages, page, d) to int8 with per-(head,
    page) scales ``127 / amax``: ``(pool_int8, scales (H_kv, n_pages)
    f32)``. Other modes cast through :func:`quantize_kv`, scales None."""
    mode = mode or _KV_DTYPE
    store = kv_storage_dtype(x.dtype, mode)
    if store != torch.int8:
        return quantize_kv(x, store, mode=mode), None
    xf = x.float()
    amax = xf.abs().amax(dim=(2, 3))
    # a tensor numerator: torch takes ``scalar / t`` as ``reciprocal(t) *
    # scalar``, two roundings where the JAX package divides once
    scales = torch.full_like(amax, 127.0) / torch.clamp_min(amax,
                                                            _KV_SCALE_EPS)
    s = xf * scales[:, :, None, None]
    return torch.clamp(torch.round(s), -127, 127).to(torch.int8), scales


def _inverse(scales):
    """1 / scales in f32, one rounding (the per-page codec's multipliers)."""
    s = scales.to(_F32)
    return torch.ones_like(s) / s


def _kv_inv_scale(pool_dtype) -> Optional[float]:
    """The fixed codec's in-kernel dequant multiplier (None: float pool)."""
    if pool_dtype == torch.int8:
        return 1.0 / _KV_QUANT_SCALE
    return None


def _count_decode_fallback(reason: str) -> None:
    from ..obs import metrics
    metrics.inc("accl_flash_decode_fallback_total",
                labels=(("reason", reason),))


def _count_prefill_fallback(reason: str) -> None:
    from ..obs import metrics
    metrics.inc("accl_flash_prefill_fallback_total",
                labels=(("reason", reason),))


# ---------------------------------------------------------------------------
# plans (``accl_tpu/ops/flash.py:1539``, ``:2198``)
# ---------------------------------------------------------------------------

def decode_plan(B: int, H: int, H_kv: int, d: int, page: int,
                pages_max: int, itemsize: int = 2, span: int = 1,
                kv_itemsize: Optional[int] = None):
    """The paged kernels' tile, ``({"gp", "dp", "vmem"}, "ok")``, or
    ``(None, reason)``: ``geometry`` (d not a multiple of 128, page not a
    multiple of 8, or of 32 for int8 pools) or ``vmem_miss`` (the TPU tile
    estimate over the 12 MiB budget). ``gp`` is g·span rounded up to 8.
    The JAX package's numbers, kept so that both decide alike."""
    if H % H_kv or B < 1 or pages_max < 1 or span < 1:
        return None, "geometry"
    if d % 128 or d == 0:
        return None, "geometry"
    kvi = kv_itemsize if kv_itemsize is not None else itemsize
    sub = 32 if kvi == 1 else 8
    if page % sub or page == 0:
        return None, "geometry"
    g = H // H_kv
    gp = -(-g * span // 8) * 8
    est = (4 * page * d * kvi
           + 3 * gp * d * 4
           + 2 * gp * 128 * 4
           + 2 * gp * page * 4)
    if est > _VMEM_BUDGET:
        return None, "vmem_miss"
    return {"gp": gp, "dp": d, "vmem": est}, "ok"


def prefill_plan(H: int, H_kv: int, d: int, page: int, pages_max: int,
                 itemsize: int = 2, chunk: Optional[int] = None,
                 kv_itemsize: Optional[int] = None):
    """The chunked-prefill tile: ``decode_plan`` at ``span = chunk``. A
    given chunk must be page-granular; ``chunk=None`` picks the largest
    page multiple <= 512 whose tile fits. ``({"chunk", "gp", "dp",
    "vmem"}, "ok")`` or ``(None, reason)``."""
    if chunk is not None:
        if chunk < 1 or chunk % page:
            return None, "geometry"
        plan, reason = decode_plan(1, H, H_kv, d, page, pages_max,
                                   itemsize, span=chunk,
                                   kv_itemsize=kv_itemsize)
        if plan is None:
            return None, reason
        return {"chunk": chunk, **plan}, "ok"
    best = None
    c = page
    while c <= 512:
        plan, _ = decode_plan(1, H, H_kv, d, page, pages_max, itemsize,
                              span=c, kv_itemsize=kv_itemsize)
        if plan is not None:
            best = {"chunk": c, **plan}
        c += page
    if best is None:
        _, reason = decode_plan(1, H, H_kv, d, page, pages_max, itemsize,
                                span=page, kv_itemsize=kv_itemsize)
        return None, reason
    return best, "ok"


def _resolve_decode(decode_mode: Optional[str]) -> str:
    mode = decode_mode or _DECODE_MODE
    if mode not in _DECODE_MODES:
        raise ValueError(f"decode_mode {mode!r} not in {_DECODE_MODES}")
    return mode


def _resolve_prefill(prefill_mode: Optional[str]) -> str:
    mode = prefill_mode or _PREFILL_MODE
    if mode not in _PREFILL_MODES:
        raise ValueError(
            f"prefill_mode {mode!r} not in {_PREFILL_MODES}")
    return mode


# ---------------------------------------------------------------------------
# kernels 29-30 (``flash.py:1590`` ``_decode_kernel``, ``:1661``
# ``_decode_span_kernel``) and their plain version
# ---------------------------------------------------------------------------

def plain_paged_decode(q4, k_pages, v_pages, block_tables, seq_lens,
                       scale: float, span: int = 1, kv_scales=None):
    """The page sweep of both paged kernels: q4 (B, H_kv, gp, d), pools
    (H_kv, n_pages, page, d) in f32, bf16 or int8, block_tables (B,
    pages_max), seq_lens (B,); out like q4. Row r of a slot's tile attends
    positions ``< len - span + 1 + r % span``. Page j of every slot is one
    exp2-domain online-softmax step (a page over 64 rows one step per
    64-row part, as the card kernels take it), taken only by slots whose
    length passes the step's first position (dead pages are skipped); int8
    pages are widened and multiplied by the inverse scale (``kv_scales``'
    per page, else the fixed codec's), and with a bf16 pool P is rounded to
    bf16 before P·V, as the TPU kernels do. A slot of length 0 gives exact
    zeros."""
    B, hkv, gp, d = q4.shape
    page = k_pages.shape[2]
    dev = q4.device
    c = scale * _LOG2E
    lens = seq_lens.to(torch.int64)
    int8 = k_pages.dtype == torch.int8
    p_dtype = _F32 if int8 else k_pages.dtype
    inv = None
    if kv_scales is not None:
        inv = _inverse(kv_scales)
    kv_inv = _kv_inv_scale(k_pages.dtype)
    qf = q4.float()
    acc = torch.zeros((B, hkv, gp, d), dtype=_F32, device=dev)
    m = torch.full((B, hkv, gp, 1), _NEG_INF, dtype=_F32, device=dev)
    l = torch.zeros((B, hkv, gp, 1), dtype=_F32, device=dev)
    rows = torch.arange(gp, device=dev)
    row_len = (lens[:, None] - span + 1 + rows % span)[:, None, :, None]
    n_live = -(-int(lens.max()) // page)
    for j in range(min(n_live, block_tables.shape[1])):
        pidx = block_tables[:, j].to(torch.int64)
        s_inv = kv_inv
        if inv is not None:
            s_inv = inv[:, pidx].transpose(0, 1)[:, :, None, None]
        for p0 in range(0, page, _PAGE_STEP):
            rows = min(_PAGE_STEP, page - p0)
            # (B, hkv, rows, d)
            kb = k_pages[:, pidx, p0:p0 + rows].transpose(0, 1).float()
            vb = v_pages[:, pidx, p0:p0 + rows].transpose(0, 1).float()
            if s_inv is not None:
                kb, vb = kb * s_inv, vb * s_inv
            s = torch.matmul(qf, kb.transpose(-1, -2)) * c
            cols = j * page + p0 + torch.arange(rows, device=dev)
            s = torch.where(cols < row_len, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            pv = torch.matmul(p.to(p_dtype).float(), vb)
            live = (j * page + p0 < lens)[:, None, None, None]
            acc = torch.where(live, acc * alpha + pv, acc)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l).to(q4.dtype)


_KV_CODE = {torch.float32: 3, torch.bfloat16: 7, torch.int8: 1}



def _decode_call(name: str, fn: str, q4, k_pages, v_pages, block_tables,
                 seq_lens, scale: float, span: int, kv_scales):
    """Launch one of ``csrc/decode.cu``'s two kernels; checks what they
    take (contiguous CUDA tensors; q f32 or bf16; pools f32, bf16 or int8;
    d 128; int32 tables and lengths)."""
    for t in (q4, k_pages, v_pages, block_tables, seq_lens):
        if t.device != q4.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on one "
                             f"device")
    if q4.dtype not in (_F32, torch.bfloat16) \
            or k_pages.dtype not in _KV_CODE or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name} takes q in f32 or bf16 and pools in f32, "
                         f"bf16 or int8, got {q4.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    B, hkv, gp, d = q4.shape
    if d != 128:
        raise ValueError(f"{name}: the card kernel takes head dim 128, got "
                         f"{d}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError(f"{name}: block tables and lengths must be int32")
    inv_ptr, kv_inv = 0, 0.0
    if kv_scales is not None:
        inv = _inverse(kv_scales).contiguous()
        inv_ptr = inv.data_ptr()
    elif k_pages.dtype == torch.int8:
        kv_inv = _kv_inv_scale(torch.int8)
    out = torch.empty_like(q4)
    n_pages, page = k_pages.shape[1], k_pages.shape[2]
    lib = cuda_build.load("decode")
    with torch.cuda.device(q4.device):
        rc = getattr(lib, fn)(
            _DT_CODE[q4.dtype], _KV_CODE[k_pages.dtype], _ptr(q4),
            _ptr(k_pages), _ptr(v_pages), _ptr(block_tables),
            _ptr(seq_lens), inv_ptr, _ptr(out), B, hkv, gp, d, n_pages,
            page, block_tables.shape[1], span,
            ctypes.c_float(scale * _LOG2E), ctypes.c_float(kv_inv),
            cuda_build.stream_handle(q4.device))
    cuda_build.check(lib, rc, name)
    return out


def paged_decode(q4, k_pages, v_pages, block_tables, seq_lens,
                 scale: float, kv_scales=None):
    """Kernel 29 (replaces ``flash.py:_decode_kernel``): one query row per
    GQA head of each slot, :func:`plain_paged_decode` at span 1. On a CUDA
    tensor it launches ``csrc/decode.cu:flash_decode_kernel``."""
    if q4.device.type != "cuda":
        return plain_paged_decode(q4, k_pages, v_pages, block_tables,
                                  seq_lens, scale, 1, kv_scales)
    out = _decode_call("flash_decode_kernel", "accl_decode_paged", q4,
                       k_pages, v_pages, block_tables, seq_lens, scale, 1,
                       kv_scales)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_span(q4, k_pages, v_pages, block_tables, seq_lens,
                      scale: float, span: int, kv_scales=None):
    """Kernel 30 (replaces ``flash.py:_decode_span_kernel``): ``span``
    query rows per GQA head laid out (g, span), each with its own causal
    horizon, :func:`plain_paged_decode` at ``span``. On a CUDA tensor it
    launches ``csrc/decode.cu:flash_decode_span_kernel``."""
    if q4.device.type != "cuda":
        return plain_paged_decode(q4, k_pages, v_pages, block_tables,
                                  seq_lens, scale, span, kv_scales)
    out = _decode_call("flash_decode_span_kernel", "accl_decode_span", q4,
                       k_pages, v_pages, block_tables, seq_lens, scale,
                       span, kv_scales)
    paged_decode_span.launches += 1
    return out


paged_decode_span.launches = 0


def _flash_decode_paged(q4, k_pages, v_pages, block_tables, seq_lens,
                        sc: float, span: int = 1, kv_scales=None):
    """Span 1 goes to kernel 29, longer spans to kernel 30, as the JAX
    package routes them."""
    q4 = q4.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    if span == 1:
        return paged_decode(q4, k_pages, v_pages, bt, lens, sc, kv_scales)
    return paged_decode_span(q4, k_pages, v_pages, bt, lens, sc, span,
                             kv_scales)


def _gather_pages(pages, block_tables):
    """(H_kv, n_pages, page, d) pool and (B, pages_max) table -> (B, H_kv,
    pages_max * page, d) chains."""
    g = pages[:, block_tables.to(torch.int64)]   # (hkv, B, pmax, page, d)
    hkv = pages.shape[0]
    B, pmax = block_tables.shape
    return g.transpose(0, 1).reshape(B, hkv, pmax * pages.shape[2],
                                     pages.shape[3])


def _decode_reference(q, k_pages, v_pages, block_tables, seq_lens,
                      sc: float, span: int = 1, kv_scales=None):
    """The unpaged reference (``flash.py:_decode_reference``): the gathered
    chains, one dense masked softmax per slot. q (B, H, d), or (B, span, H,
    d) with row j's horizon ``len - span + 1 + j``."""
    if span == 1:
        B, H, d = q.shape
        q = q[:, None]
    else:
        B, _, H, d = q.shape
    hkv = k_pages.shape[0]
    g = H // hkv
    k = _gather_pages(dequantize_kv(k_pages, scales=kv_scales), block_tables)
    v = _gather_pages(dequantize_kv(v_pages, scales=kv_scales), block_tables)
    qg = q.reshape(B, span, hkv, g, d).float()
    s = torch.einsum("bjhgd,bhsd->bjhgs", qg, k) * sc
    row_len = (seq_lens.to(torch.int64)[:, None] - span + 1
               + torch.arange(span, device=q.device)[None, :])
    live = (torch.arange(k.shape[2], device=q.device)[None, None, :]
            < row_len[:, :, None])[:, :, None, None, :]
    s = torch.where(live, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bjhgs,bhsd->bjhgd", p / torch.where(l > 0, l, 1.0),
                       v)
    out = out.reshape(B, span, H, d).to(q.dtype)
    return out[:, 0] if span == 1 else out


def _check_kv_scales(kv_scales, k_pages) -> None:
    """Per-(head, page) scales belong to int8 pools, one per (kv head, pool
    page)."""
    if kv_scales is None:
        return
    if k_pages.dtype != torch.int8:
        raise ValueError(
            f"kv_scales given but the pool dtype is {k_pages.dtype} — "
            f"the per-(head,page) codec is int8-at-rest only")
    want = (k_pages.shape[0], k_pages.shape[1])
    if tuple(kv_scales.shape) != want:
        raise ValueError(
            f"kv_scales shape {tuple(kv_scales.shape)} != (H_kv, n_pages) "
            f"{want}")


def flash_decode(q, k_pages, v_pages, block_tables, seq_lens,
                 scale: Optional[float] = None,
                 decode_mode: Optional[str] = None, kv_scales=None):
    """Single-query attention over the paged KV cache, one decode step:
    q (B, H, d), pools (H_kv, n_pages, page, d) with ``H % H_kv == 0``,
    block_tables (B, pages_max), seq_lens (B,) (append the token first).
    Returns (B, H, d) in q's dtype; a slot of length 0 gives zeros. Where
    ``decode_plan`` admits the geometry, kernel 29 runs; otherwise, or in
    mode "unpaged", the gathered-chain reference, counted per reason in
    ``accl_flash_decode_fallback_total``. ``kv_scales`` (H_kv, n_pages)
    switches int8 pools to the per-page codec."""
    B, H, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d:
        raise ValueError(
            f"k/v pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
            f"incompatible with q {tuple(q.shape)}: need (H_kv, n_pages, "
            f"page, d)")
    hkv = k_pages.shape[0]
    if H % hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {hkv}")
    if block_tables.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} must lead with the slot dim B={B}")
    _check_kv_scales(kv_scales, k_pages)
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _resolve_decode(decode_mode) != "paged":
        _count_decode_fallback("mode")
        return _decode_reference(q, k_pages, v_pages, block_tables,
                                 seq_lens, sc, kv_scales=kv_scales)
    plan, reason = decode_plan(B, H, hkv, d, k_pages.shape[2],
                               block_tables.shape[1], q.element_size(),
                               kv_itemsize=k_pages.element_size())
    if plan is None:
        _count_decode_fallback(reason)
        return _decode_reference(q, k_pages, v_pages, block_tables,
                                 seq_lens, sc, kv_scales=kv_scales)
    g, gp = H // hkv, plan["gp"]
    q4 = torch.nn.functional.pad(q.reshape(B, hkv, g, d),
                                 (0, 0, 0, gp - g))
    out = _flash_decode_paged(q4, k_pages, v_pages, block_tables, seq_lens,
                              sc, kv_scales=kv_scales)
    return out[:, :, :g].reshape(B, H, d)


# ---------------------------------------------------------------------------
# the cache writes (``flash.py:2007``, ``:2056``) and chunked prefill
# (``:2246``)
# ---------------------------------------------------------------------------

def _write_rows(k_pages, v_pages, ok, pidx, off, kn, vn) -> None:
    """Rows ``kn[:, lane]`` into pool page ``pidx[lane]``, row
    ``off[lane]``, for the lanes where ``ok`` holds; the others are
    dropped (the JAX scatter's ``mode="drop"``). Selecting the lanes reads
    ``ok`` back to the host: one sync a call. A dropped lane is never
    redirected to a real row, which could be a live lane's."""
    sel = ok.nonzero(as_tuple=True)
    k_pages[:, pidx[sel], off[sel]] = kn[(slice(None), *sel)]
    v_pages[:, pidx[sel], off[sel]] = vn[(slice(None), *sel)]


def kv_cache_append(k_pages, v_pages, block_tables, seq_lens, k_new, v_new,
                    active=None):
    """Each slot's new token (k_new, v_new (B, H_kv, d)) into its chain at
    position ``seq_lens[b]``: pool page ``block_tables[b, pos // page]``,
    row ``pos % page``. A token one past capacity, and every slot that
    ``active`` (B,) masks, writes nothing and keeps its length. Rows are
    cast through :func:`quantize_kv`. Returns ``(k_pages, v_pages,
    seq_lens')``; the pools are written in place (the JAX scatter returns
    new ones), so the returned pools are the given tensors. Block tables
    must name disjoint pages across slots."""
    page = k_pages.shape[2]
    pages_max = block_tables.shape[1]
    pos = seq_lens.to(torch.int64)
    ok = pos < pages_max * page
    if active is not None:
        ok = ok & active
    pidx = torch.gather(block_tables.to(torch.int64), 1,
                        torch.clamp(pos // page, 0, pages_max - 1)[:, None]
                        )[:, 0]
    kn = quantize_kv(k_new.transpose(0, 1), k_pages.dtype)
    vn = quantize_kv(v_new.transpose(0, 1), v_pages.dtype)
    _write_rows(k_pages, v_pages, ok, pidx, pos % page, kn, vn)
    return k_pages, v_pages, seq_lens + ok.to(seq_lens.dtype)


def kv_cache_append_multi(k_pages, v_pages, block_tables, seq_lens, k_new,
                          v_new, count=None, active=None):
    """Up to T tokens per slot (k_new, v_new (B, T, H_kv, d)): token j of
    slot b at position ``seq_lens[b] + j``, each token walking the block
    table on its own (a span may cross pages). ``count`` (B,) keeps the
    first ``count[b]`` tokens, ``active`` masks slots, writes past capacity
    are dropped and the lengths capped. In place, as
    :func:`kv_cache_append`; at ``kv_cache_dtype="off"`` the pools equal T
    sequential appends."""
    B, T = k_new.shape[:2]
    page = k_pages.shape[2]
    pages_max = block_tables.shape[1]
    j = torch.arange(T, device=seq_lens.device)
    pos = seq_lens.to(torch.int64)[:, None] + j[None, :]
    ok = pos < pages_max * page
    if count is not None:
        ok = ok & (j[None, :] < count.to(torch.int64)[:, None])
    if active is not None:
        ok = ok & active[:, None]
    pidx = torch.gather(block_tables.to(torch.int64), 1,
                        torch.clamp(pos // page, 0, pages_max - 1))
    kn = quantize_kv(k_new.movedim(2, 0), k_pages.dtype)
    vn = quantize_kv(v_new.movedim(2, 0), v_pages.dtype)
    _write_rows(k_pages, v_pages, ok, pidx, pos % page, kn, vn)
    return k_pages, v_pages, seq_lens + ok.sum(1).to(seq_lens.dtype)


def flash_prefill(q, k, v, k_pages, v_pages, block_tables, seq_lens, slot,
                  live=None, scale: Optional[float] = None,
                  prefill_mode: Optional[str] = None):
    """One chunk of one slot's prompt into the paged cache: q (C, H, d), k
    and v (C, H_kv, d) land in slot ``slot``'s chain from its current
    length (the first ``live`` rows, default C), and the chunk's causal
    attention runs over everything written so far in one span-C sweep
    (kernel 30) where ``prefill_plan`` admits the chunk (page-granular),
    else, or in mode "unpaged", through the gathered-chain reference,
    counted per reason in ``accl_flash_prefill_fallback_total``. Rows past
    ``live`` are padding. Returns ``(out (C, H, d), k_pages, v_pages,
    seq_lens')``; the pools are written in place."""
    C, H, d = q.shape
    if k.shape != v.shape or tuple(k.shape) != (C, k.shape[1], d):
        raise ValueError(
            f"k/v chunk {tuple(k.shape)}/{tuple(v.shape)} incompatible "
            f"with q {tuple(q.shape)}: need (C, H_kv, d)")
    hkv = k.shape[1]
    if H % hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {hkv}")
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    page = k_pages.shape[2]
    pages_max = block_tables.shape[1]
    slot = int(slot)
    bt_row = block_tables[slot:slot + 1].to(torch.int32)
    lens_row = seq_lens[slot:slot + 1]
    count = None if live is None else torch.full(
        (1,), int(live), dtype=torch.int64, device=seq_lens.device)
    kp2, vp2, lens_row2 = kv_cache_append_multi(
        k_pages, v_pages, bt_row, lens_row, k[None], v[None], count=count)
    new_lens = seq_lens.clone()
    new_lens[slot:slot + 1] = lens_row2
    # the attention runs at the full chunk: rows past `live` are padding
    attn_lens = lens_row.to(torch.int32) + C
    plan, reason = None, "mode"
    if _resolve_prefill(prefill_mode) == "paged":
        plan, reason = prefill_plan(H, hkv, d, page, pages_max,
                                    q.element_size(), chunk=C,
                                    kv_itemsize=k_pages.element_size())
    if plan is None:
        _count_prefill_fallback(reason)
        out = _decode_reference(q[None], kp2, vp2, bt_row, attn_lens, sc,
                                span=C)[0]
        return out, kp2, vp2, new_lens
    g, gp = H // hkv, plan["gp"]
    q4 = q.reshape(1, C, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(1, hkv, g * C, d)
    q4 = torch.nn.functional.pad(q4, (0, 0, 0, gp - g * C))
    out = _flash_decode_paged(q4, kp2, vp2, bt_row, attn_lens, sc, span=C)
    out = out[:, :, :g * C].reshape(1, hkv, g, C, d)
    return out.permute(0, 3, 1, 2, 4).reshape(C, H, d), kp2, vp2, new_lens
