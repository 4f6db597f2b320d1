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
per call. The head-packed d=64 arm, the paged decode and prefill arms and
their KV codecs are not ported yet (``ROADMAP.md`` queue 2, rows 25-30).
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


def _bwd_operands(what: str, q, k, v, do, lse, dd):
    code, dp = _card_operands(what, q, k, v, (do, lse, dd))
    H, S, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("dd", dd)):
        if tuple(t.shape) != (H, S) or t.dtype != _F32:
            raise ValueError(f"{what}: {name} must be (H, S) f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return code, dp


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
    runs = -(-nkt // max(1, _DQ_SLAB_BUDGET // (H * S * d * 4)))
    run = -(-nkt // runs)         # k tiles a launch, as even as runs allow
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

def _bwd_from_dd(q, k, v, do, lse, dd, causal, sc, block_q, block_k, bwd):
    """The shared backward: ``dd`` (H, S) is rowsum(dO ∘ O), less dlse when
    lse has a cotangent. Mode "fused" runs the fused kernel where the JAX
    backward policy finds a geometry; otherwise, or in mode "two_pass", the
    dK/dV and dQ pair runs at the forward's blocks."""
    H, S, d = q.shape
    cpu = q.device.type != "cuda"
    if bwd == "fused":
        dp = -(-d // 128) * 128
        blocks = _bwd_default_blocks(S, dp, causal, _itemsize(q.dtype), cpu)
        if blocks is not None:
            dq, dk, dv = flash_bwd_fused(q, k, v, do, lse, dd, causal, sc,
                                         *blocks)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    dk, dv = flash_bwd_kv(q, k, v, do, lse, dd, causal, sc, block_q, block_k)
    dq = flash_bwd_q(q, k, v, do, lse, dd, causal, sc, block_q, block_k)
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
