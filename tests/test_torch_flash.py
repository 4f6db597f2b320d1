"""The port's flash attention training arm (``accl_tpu_torch.ops.flash``)
against the JAX package's (``accl_tpu.ops.flash``) on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (128 x 128 blocks,
the geometry both packages take on the CPU); the port runs the plain
versions of its four kernels, which is what its wrappers do with CPU
tensors. One JAX ``vjp`` per configuration (H 2 at S 256, d 64 and 96,
causal and not, grouped-query H 4 / H_kv 2, one bf16 case) gives the
output, the lse and the gradients under an output and an lse cotangent.
Tolerances: out and lse within 2e-6 in f32 (the two sum the same products
in other orders; measured up to 4.8e-7); gradients within 1e-5 of each
tensor's largest magnitude in both backward modes (measured up to 1.3e-6);
bf16 within 1e-2 of the largest magnitude (a bf16 ulp is 2^-8 of it;
measured up to 9.3e-4). The
block and backward-arm policies are compared number for number at hardware
geometry (JAX's interpret switch patched off), and the shape errors where
JAX raises. One test loops over every case and names the failing one.

The head-packed d=64 arm (``flash_attention_packed``) has a test of its
own, on the same plan: one JAX ``vjp`` per configuration (H 4 causal and H
2 non-causal in f32, H 2 causal in bf16, S 256), the port's plain packed
versions in both backward modes, the same tolerances (measured: out up
to 2.4e-7, gradients up to 8.1e-7 of scale, bf16 up to 2.6e-4); the
port's packed and general arms bit-equal at d 64; the envelope; the packed
entry's block and backward-arm policies and its shape errors against
JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.ops import flash as jf

import accl_tpu_torch as at
from accl_tpu_torch.ops import flash as tf

torch.set_num_threads(1)

#: (H, H_kv, d, causal, dtype) at S 256
CASES = [(2, 2, 64, False, "f32"), (2, 2, 64, True, "f32"),
         (2, 2, 96, False, "f32"), (4, 2, 96, True, "f32"),
         (2, 2, 64, True, "bf16")]
S = 256
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, H, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((H, S, d)).astype(np.float32)
    k = rng.standard_normal((hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((hkv, S, d)).astype(np.float32)
    do = rng.standard_normal((H, S, d)).astype(np.float32)
    dlse = rng.standard_normal((H, S)).astype(np.float32)
    return q, k, v, do, dlse


def _jax_oracle(q, k, v, do, dlse, causal, dt):
    jd = _DT[dt][0]
    (o, lse), vjp = jax.vjp(
        lambda a, b, c: jf.flash_attention_lse(a, b, c, causal=causal),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp((jnp.asarray(do, jd), jnp.asarray(dlse, jnp.float32)))
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in (o, lse, *grads)]


def _port(q, k, v, do, dlse, causal, dt, mode, with_lse=True):
    td = _DT[dt][1]
    ts = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    if with_lse:
        o, lse = tf.flash_attention_lse(*ts, causal=causal, bwd_mode=mode)
        loss = (o.float() * torch.from_numpy(do).to(td).float()).sum() \
            + (lse * torch.from_numpy(dlse)).sum()
    else:
        o = tf.flash_attention(*ts, causal=causal, bwd_mode=mode)
        lse = torch.zeros(())
        loss = (o.float() * torch.from_numpy(do).to(td).float()).sum()
    loss.backward()
    return [x.detach().float().numpy()
            for x in (o, lse, *(t.grad for t in ts))]


def _close(what, got, want, rel):
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{what}: max|err| {err} > {rel} x {top}"


def test_flash_matches_jax(monkeypatch):
    for n, (H, hkv, d, causal, dt) in enumerate(CASES):
        q, k, v, do, dlse = _inputs(10 + n, H, hkv, d)
        want = _jax_oracle(q, k, v, do, dlse, causal, dt)
        case = f"H {H} H_kv {hkv} d {d} causal {causal} {dt}"
        grads = {}
        for mode in ("fused", "two_pass"):
            got = _port(q, k, v, do, dlse, causal, dt, mode)
            tol = 1e-2 if dt == "bf16" else None
            for name, a, b in zip(("out", "lse"), got, want):
                if tol:
                    _close(f"{case} {name}", a, b, tol)
                else:
                    err = float(np.abs(a - b).max())
                    assert err <= 2e-6, f"{case} {name}: {err}"
            for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
                _close(f"{case} {mode} {name}", a, b, tol or 1e-5)
            grads[mode] = got[2:]
        # at equal blocks the two arms sum in one order: equal bits
        for a, b in zip(grads["fused"], grads["two_pass"]):
            assert np.array_equal(a, b), f"{case}: fused != two_pass"
    _flash_attention_is_the_lse_arm()
    _policies_match_jax(monkeypatch)
    _shape_errors_match_jax()
    _mode_register()
    # CPU tensors never reach a kernel
    for fn in (tf.flash_fwd, tf.flash_bwd_fused, tf.flash_bwd_kv,
               tf.flash_bwd_q):
        assert fn.launches == 0, fn.__name__


def _flash_attention_is_the_lse_arm():
    """``flash_attention``'s gradient is ``flash_attention_lse``'s with no
    lse cotangent, bit for bit; (S, d) inputs are promoted and squeezed."""
    q, k, v, do, _ = _inputs(3, 2, 1, 64)
    zero = np.zeros((2, S), np.float32)
    for mode in ("fused", "two_pass"):
        a = _port(q, k, v, do, zero, True, "f32", mode, with_lse=False)
        b = _port(q, k, v, do, zero, True, "f32", mode)
        for x, y, name in zip(a[2:], b[2:], ("dq", "dk", "dv")):
            assert np.array_equal(x, y), (mode, name)
    t = [torch.from_numpy(x[0]) for x in (q, k, v)]
    out, lse = tf.flash_attention_lse(*t, causal=True)
    full, full_lse = tf.flash_attention_lse(*(x[None] for x in t),
                                            causal=True)
    assert out.shape == (S, 64) and lse.shape == (S,)
    assert torch.equal(out, full[0]) and torch.equal(lse, full_lse[0])


def _policies_match_jax(monkeypatch):
    """The forward block policy and the fused backward's (None: two-pass) at
    hardware geometry, number for number; the CPU takes (128, 128)."""
    monkeypatch.setattr(jf, "_interpret_params", lambda: None)
    for S_ in (128, 256, 384, 640, 1024, 1536, 2048, 3072, 4096, 6144,
               8192, 12288, 16384, 32768):
        for d in (32, 64, 96, 128, 192, 256):
            for causal in (False, True):
                for isz in (2, 4):
                    for bq, bk in ((None, None), (128, None), (None, 256),
                                   (256, 128)):
                        assert tf._default_blocks(S_, d, causal, bq, bk,
                                                  isz) == \
                            jf._default_blocks(S_, d, causal, bq, bk, isz), \
                            ("fwd", S_, d, causal, isz, bq, bk)
                    dp = -(-d // 128) * 128
                    assert tf._bwd_default_blocks(S_, dp, causal, isz) == \
                        jf._bwd_default_blocks(S_, dp, causal, isz), \
                        ("bwd", S_, dp, causal, isz)
    # the arms the card takes at the context-parallel shapes: fused at S
    # 8192, two-pass (None) at S 16384
    assert tf._bwd_default_blocks(8192, 128, True, 4) == (512, 512)
    assert tf._bwd_default_blocks(16384, 128, True, 4) is None
    assert tf._default_blocks(8192, 96, True, None, None, 4, cpu=True) == \
        (128, 128)
    assert tf._bwd_default_blocks(16384, 128, True, 4, cpu=True) == \
        (128, 128)
    monkeypatch.undo()


def _shape_errors_match_jax():
    """``_check_shapes`` raises where the JAX entry points raise."""
    z = np.zeros
    cases = [  # (q, k, v shapes, block_q, block_k)
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), 64, None),
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), 384, None),
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), None, 96),
        ((3, 256, 64), (2, 256, 64), (2, 256, 64), None, None),
        ((2, 256, 64), (2, 256, 64), (2, 128, 64), None, None),
        ((2, 256, 64), (2, 256, 32), (2, 256, 32), None, None),
        ((2, 200, 64), (2, 200, 64), (2, 200, 64), None, None),
    ]
    for qs, ks, vs, bq, bk in cases:
        raised = []
        for fn, mk in ((jf.flash_attention, jnp.asarray),
                       (tf.flash_attention, torch.from_numpy)):
            try:
                fn(mk(z(qs, np.float32)), mk(z(ks, np.float32)),
                   mk(z(vs, np.float32)), block_q=bq, block_k=bk)
                raised.append(False)
            except ValueError:
                raised.append(True)
        assert raised[0] == raised[1], (qs, ks, vs, bq, bk, raised)
    args = (torch.zeros(4, 256, 64), torch.zeros(2, 256, 64),
            torch.zeros(2, 256, 64), 256, 64, 128, 256)
    tf._check_shapes(*args)        # grouped-query: no error
    jf._check_shapes(*(a.numpy() if torch.is_tensor(a) else a
                       for a in args))
    # kept divergence: the card kernels take head dims up to 128
    assert tf._card_head_dim(96) == 96 and tf._card_head_dim(33) == 64
    with pytest.raises(ValueError, match="up to 128"):
        tf._card_head_dim(160)


def _mode_register():
    """``ACCLConfig.flash_bwd`` is written through to the module default;
    a bad mode raises, per call and through the register."""
    acc = at.ACCL(world=2, device="cpu")
    try:
        acc.config = acc.config.replace(flash_bwd="two_pass")
        assert tf.get_flash_bwd_mode() == "two_pass"
        with pytest.raises(ValueError, match="flash_bwd"):
            acc.config = acc.config.replace(flash_bwd="three_pass")
        assert acc.config.flash_bwd == "two_pass"
        with pytest.raises(ValueError, match="bwd_mode"):
            tf.flash_attention(torch.zeros(128, 64), torch.zeros(128, 64),
                               torch.zeros(128, 64), bwd_mode="x")
    finally:
        acc.config = acc.config.replace(flash_bwd="fused")
    assert tf.get_flash_bwd_mode() == "fused"


#: (H, causal, dtype) of the packed arm at S 256, d 64
PACKED_CASES = [(4, True, "f32"), (2, False, "f32"), (2, True, "bf16")]


def test_flash_packed_matches_jax(monkeypatch):
    for n, (H, causal, dt) in enumerate(PACKED_CASES):
        q, k, v, do, _ = _inputs(40 + n, H, H, 64)
        jd, td = _DT[dt]
        out, vjp = jax.vjp(
            lambda a, b, c: jf.flash_attention_packed(a, b, c, causal=causal),
            *(jnp.asarray(x, jd) for x in (q, k, v)))
        want = [np.asarray(jnp.asarray(x, jnp.float32))
                for x in (out, *vjp(jnp.asarray(do, jd)))]
        case = f"packed H {H} causal {causal} {dt}"
        tol = 1e-2 if dt == "bf16" else None
        got = {}
        for arm, fn in (("packed", tf.flash_attention_packed),
                        ("general", tf.flash_attention)):
            for mode in ("fused", "two_pass"):
                ts = [torch.from_numpy(x).to(td).requires_grad_()
                      for x in (q, k, v)]
                o = fn(*ts, causal=causal, bwd_mode=mode)
                (o.float() * torch.from_numpy(do).to(td).float()).sum() \
                    .backward()
                got[arm, mode] = [x.detach().float().numpy()
                                  for x in (o, *(t.grad for t in ts))]
        for mode in ("fused", "two_pass"):
            res = got["packed", mode]
            if tol:
                _close(f"{case} out", res[0], want[0], tol)
            else:
                err = float(np.abs(res[0] - want[0]).max())
                assert err <= 2e-6, f"{case} out: {err}"
            for name, a, b in zip(("dq", "dk", "dv"), res[1:], want[1:]):
                _close(f"{case} {mode} {name}", a, b, tol or 1e-5)
        # each lane half runs the general arm's arithmetic: equal bits
        for key, res in got.items():
            for name, a, b in zip(("out", "dq", "dk", "dv"), res,
                                  got["general", "fused"]):
                assert np.array_equal(a, b), f"{case} {key} {name}"
    _packed_envelope(monkeypatch)
    _packed_policies_match_jax(monkeypatch)
    _packed_shape_errors_match_jax()
    # CPU tensors never reach a kernel
    for fn in (tf.flash_fwd_packed, tf.flash_bwd_fused_packed,
               tf.flash_bwd_kv_packed, tf.flash_bwd_q_packed):
        assert fn.launches == 0, fn.__name__


def _packed_envelope(monkeypatch):
    """An odd H, d != 64, grouped-query k/v and a 2-D q go to
    ``flash_attention`` (equal results, the packed Function never runs);
    the pack is the JAX package's pairing, (2p, 2p + 1) on lane halves."""
    def refuse(*args):
        raise AssertionError("the packed arm ran outside its envelope")

    rng = np.random.default_rng(7)
    cases = [((3, 128, 64), (3, 128, 64)), ((4, 128, 96), (4, 128, 96)),
             ((4, 128, 64), (2, 128, 64)), ((128, 64), (128, 64))]
    with monkeypatch.context() as m:
        m.setattr(tf._FlashPacked, "apply", refuse)
        for qs, ks in cases:
            q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for s in (qs, ks, ks))
            assert torch.equal(tf.flash_attention_packed(q, k, v),
                               tf.flash_attention(q, k, v)), (qs, ks)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    p = tf._pack_heads(torch.from_numpy(x))
    assert np.array_equal(p.numpy(), np.asarray(jf._pack_heads(x)))
    assert torch.equal(tf._unpack_heads(p), torch.from_numpy(x))
    assert torch.equal(p[1, 5, 64:], torch.from_numpy(x[3, 5]))


def _packed_policies_match_jax(monkeypatch):
    """The packed entry's forward blocks (``_default_blocks`` at 2d = 128)
    and its backward arm (``_bwd_default_blocks`` at the packed 128 lanes;
    None: two-pass) at hardware geometry, number for number; the CPU takes
    (128, 128)."""
    monkeypatch.setattr(jf, "_interpret_params", lambda: None)
    for S_ in (128, 256, 384, 640, 1024, 1536, 2048, 3072, 4096, 6144,
               8192, 12288, 16384, 32768):
        for causal in (False, True):
            for isz in (2, 4):
                for bq, bk in ((None, None), (128, None), (None, 256),
                               (256, 128)):
                    assert tf._packed_blocks(S_, causal, bq, bk, isz,
                                             False) == \
                        jf._default_blocks(S_, 128, causal, bq, bk, isz), \
                        ("fwd", S_, causal, isz, bq, bk)
                assert tf._bwd_default_blocks(S_, 2 * tf._PACKED_D, causal,
                                              isz) == \
                    jf._bwd_default_blocks(S_, 128, causal, isz), \
                    ("bwd", S_, causal, isz)
    # the arms phase 3l of the smoke run takes: fused at S 2048, two-pass
    # (None) at S 16384 causal
    assert tf._bwd_default_blocks(2048, 128, True, 4) is not None
    assert tf._bwd_default_blocks(16384, 128, True, 4) is None
    assert tf._packed_blocks(2048, True, None, None, 4, True) == (128, 128)
    monkeypatch.undo()


def _packed_shape_errors_match_jax():
    """The packed entry raises where the JAX packed entry raises."""
    z = np.zeros
    cases = [  # (q, k, v shapes, block_q, block_k)
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), 64, None),
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), 384, None),
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), None, 96),
        ((2, 256, 64), (2, 128, 64), (2, 128, 64), None, None),
        ((2, 256, 64), (2, 256, 32), (2, 256, 32), None, None),
        ((2, 200, 64), (2, 200, 64), (2, 200, 64), None, None),
        ((2, 256, 64), (2, 256, 64), (2, 256, 64), 256, 128),
    ]
    for qs, ks, vs, bq, bk in cases:
        raised = []
        for fn, mk in ((jf.flash_attention_packed, jnp.asarray),
                       (tf.flash_attention_packed, torch.from_numpy)):
            try:
                fn(mk(z(qs, np.float32)), mk(z(ks, np.float32)),
                   mk(z(vs, np.float32)), block_q=bq, block_k=bk)
                raised.append(False)
            except ValueError:
                raised.append(True)
        assert raised[0] == raised[1], (qs, ks, vs, bq, bk, raised)
