"""The port's serving arm (``accl_tpu_torch.ops.flash`` decode and prefill,
the KV codecs and cache writes, ``accl_tpu_torch.models.decode``) against
the JAX package's on the same numpy inputs.

* Kernel entry points: ``flash_decode`` and ``flash_prefill`` of the port
  (the plain version of kernels 29-30, which is what the wrappers run on
  CPU tensors) against the JAX functions with their Pallas kernels in
  interpret mode, at d 128 over g 1, 6 and 8, pages 8 and 32, f32, bf16 and
  int8 pools (int8 with per-page scales too), lengths 0, one full page and
  full capacity, and partial final prefill chunks: within 1e-5 of the
  output's largest magnitude (f32 sums in another order). The plans number
  for number over a sweep, and one decline per reason (``geometry``,
  ``vmem_miss``, ``mode``) with its counter.
* Codecs and appends: the codecs bit-equal at "off", "bf16" and "int8"
  (and the per-page int8 codec), the appends bit-equal into f32 and int8
  pools with exact lengths; "bf16_sr" in distribution only (the JAX lane
  rounds deterministically off the TPU).
* The steps: ``build_decode_step`` and ``build_prefill_step`` at tp 2,
  d_model 256, 4 heads over 2 KV heads, page 8, 4 slots through admission,
  two prefill chunks (the second partial), three decode steps, a
  retirement and one more step, fused and baseline, paged and unpaged, and
  ``decode_step_reference``, against the JAX steps (baseline, unpaged: the
  fused and paged arms are the same math there); dyadic integer operands
  make every projection exact, so the pools and lengths are bit-equal and
  the outputs within 1e-5 of scale. ``decode_engage_reasons`` equal; the
  ``config`` write-through of the four serving registers.

One test loops over every case and names the failing one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.models import decode as jdm
from accl_tpu.ops import flash as jf

import accl_tpu_torch as at
from accl_tpu_torch.models import decode as tdm
from accl_tpu_torch.obs import metrics as tmetrics
from accl_tpu_torch.ops import compression as tcp
from accl_tpu_torch.ops import flash as tf

torch.set_num_threads(1)

D = 128
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_T = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# the JAX oracles jitted: one compile each instead of one per eager op
_jdecode = jax.jit(jf.flash_decode)
_jprefill = jax.jit(jf.flash_prefill, static_argnames=("slot", "live"))
_jquant = jax.jit(jf.quantize_kv, static_argnums=(1,),
                  static_argnames=("mode",))
_jquant_paged = jax.jit(jf.quantize_kv_paged, static_argnames=("mode",))
_jappend = jax.jit(jf.kv_cache_append)
_jappend_multi = jax.jit(jf.kv_cache_append_multi)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                    else x)


def _tnp(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(what, got, want, rel=1e-5):
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{what}: max|err| {err} > {rel} x {top}"


def _pools(rng, hkv, n_pages, page, dt):
    """f32 K and V pools, their at-rest pair in both packages and the
    per-page scales (``dt`` "int8pp")."""
    kf = rng.standard_normal((hkv, n_pages, page, D)).astype(np.float32)
    vf = rng.standard_normal((hkv, n_pages, page, D)).astype(np.float32)
    if dt == "int8pp":
        # one scale grid for both pools: K's
        jk, sc = _jquant_paged(jnp.asarray(kf), mode="int8")
        jv = jnp.asarray(np.clip(np.round(vf * np.asarray(sc)[:, :, None,
                                                               None]),
                                 -127, 127).astype(np.int8))
        return (jk, jv, sc), (torch.from_numpy(_np(jk)),
                              torch.from_numpy(_np(jv)),
                              torch.from_numpy(_np(sc)))
    jk, jv = (jnp.asarray(x, _J[dt]) for x in (kf, vf))
    tk, tv = (torch.from_numpy(_np(x)).to(_T[dt]) for x in (jk, jv))
    return (jk, jv, None), (tk, tv, None)


def _table(rng, B, pmax):
    return rng.permutation(B * pmax).astype(np.int32).reshape(B, pmax)


def _entry_points():
    """flash_decode and flash_prefill against the JAX kernels."""
    rng = np.random.default_rng(7)
    # (H, H_kv, page, pool dtype): g 6 / page 8 / bf16, g 8 / page 32 /
    # int8 with per-page scales; 3 slots of pages_max 2 at lengths 0, one
    # page and full capacity
    for H, hkv, page, dt in ((6, 1, 8, "bf16"), (16, 2, 32, "int8pp")):
        case = f"flash_decode H {H} H_kv {hkv} page {page} {dt}"
        B, pmax = 3, 2
        (jk, jv, js), (tk, tv, ts) = _pools(rng, hkv, B * pmax, page, dt)
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        bt = _table(rng, B, pmax)
        lens = np.array([0, page, pmax * page], np.int32)
        want = _np(_jdecode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                            jnp.asarray(lens), kv_scales=js))
        got = tf.flash_decode(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(bt), torch.from_numpy(lens),
                              kv_scales=ts).numpy()
        assert np.all(got[0] == 0.0), f"{case}: a length-0 slot is not 0"
        _close(case, got, want)
    # (H, H_kv, page, pool dtype, chunk, start, live): g 1 / page 8 / f32,
    # g 8 / page 32 / int8; both end in a partial chunk
    for H, hkv, page, dt, C, start, live in ((2, 2, 8, "f32", 16, 8, 11),
                                            (16, 2, 32, "int8", 32, 32, 29)):
        case = f"flash_prefill H {H} H_kv {hkv} page {page} {dt} C {C}"
        B, pmax, slot = 3, 4, 1
        (jk, jv, _), (tk, tv, _) = _pools(rng, hkv, B * pmax, page, dt)
        q = rng.standard_normal((C, H, D)).astype(np.float32)
        k = rng.standard_normal((C, hkv, D)).astype(np.float32)
        v = rng.standard_normal((C, hkv, D)).astype(np.float32)
        bt = _table(rng, B, pmax)
        lens = np.array([3, start, pmax * page], np.int32)
        jo, jkp, jvp, jl = _jprefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jk, jv,
            jnp.asarray(bt), jnp.asarray(lens), slot, live=live)
        to, tkp, tvp, tl = tf.flash_prefill(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tk, tv, torch.from_numpy(bt), torch.from_numpy(lens), slot,
            live=live)
        _close(case, to.numpy()[:live], _np(jo)[:live])
        for name, a, b in (("k pool", tkp, jkp), ("v pool", tvp, jvp)):
            assert np.array_equal(_tnp(a), _np(b)), f"{case}: {name}"
        assert np.array_equal(tl.numpy(), np.asarray(jl)), f"{case}: lens"


def _counter(key):
    return tmetrics.snapshot()["counters"].get(key, 0.0)


def _plans_and_declines(monkeypatch):
    """The plans number for number; one decline per reason, counted."""
    for H, hkv in ((8, 1), (64, 8), (6, 3), (7, 2)):
        for d in (64, 128, 256):
            for page in (8, 16, 32, 64, 24):
                for isz, kvi in ((4, None), (2, None), (4, 1)):
                    for span in (1, 4, 448):
                        args = (4, H, hkv, d, page, 128, isz)
                        assert tf.decode_plan(*args, span=span,
                                              kv_itemsize=kvi) == \
                            jf.decode_plan(*args, span=span,
                                           kv_itemsize=kvi), (args, span)
                    for chunk in (None, page, 2 * page, 100, 448):
                        args = (H, hkv, d, page, 128, isz)
                        assert tf.prefill_plan(*args, chunk=chunk,
                                               kv_itemsize=kvi) == \
                            jf.prefill_plan(*args, chunk=chunk,
                                            kv_itemsize=kvi), (args, chunk)
    rng = np.random.default_rng(3)
    B, pmax, page = 2, 2, 8
    for reason, d, mode, budget in (("geometry", 64, None, None),
                                    ("vmem_miss", D, None, 1 << 14),
                                    ("mode", D, "unpaged", None)):
        if budget:
            monkeypatch.setattr(tf, "_VMEM_BUDGET", budget)
        q = torch.from_numpy(rng.standard_normal((B, 4, d))
                             .astype(np.float32))
        kp = torch.from_numpy(rng.standard_normal((2, B * pmax, page, d))
                              .astype(np.float32))
        bt = torch.arange(B * pmax, dtype=torch.int32).reshape(B, pmax)
        lens = torch.tensor([5, 16], dtype=torch.int32)
        key = f'accl_flash_decode_fallback_total{{reason="{reason}"}}'
        before = _counter(key)
        out = tf.flash_decode(q, kp, kp, bt, lens, decode_mode=mode)
        assert _counter(key) == before + 1, reason
        want = tf._decode_reference(q, kp, kp, bt, lens, d ** -0.5)
        assert torch.equal(out, want), reason
        # the prefill counter, through the same verdicts
        key = f'accl_flash_prefill_fallback_total{{reason="{reason}"}}'
        before = _counter(key)
        C = 8
        kc = torch.from_numpy(rng.standard_normal((C, 2, d))
                              .astype(np.float32))
        tf.flash_prefill(q[0, None].expand(C, 4, d).contiguous(), kc, kc,
                         kp.clone(), kp.clone(), bt, lens, 0,
                         prefill_mode=mode)
        assert _counter(key) == before + 1, f"prefill {reason}"
        monkeypatch.setattr(tf, "_VMEM_BUDGET", 12 << 20)


def _codecs_and_appends():
    """Codecs bit-equal, appends bit-equal with exact lengths."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    for pool in ("f32", "bf16", "int8"):
        want = _np(_jquant(jnp.asarray(x), _J[pool], mode="off"))
        got = _tnp(tf.quantize_kv(torch.from_numpy(x), _T[pool], mode="off"))
        assert np.array_equal(got, want), f"quantize_kv {pool}"
    for mode in ("off", "bf16", "int8", "bf16_sr"):
        assert jnp.dtype(jf.kv_storage_dtype(jnp.float32, mode)).name == \
            str(tf.kv_storage_dtype(torch.float32, mode)).split(".")[-1], mode
    pools = rng.standard_normal((2, 6, 8, D)).astype(np.float32) * 3
    jq, js = _jquant_paged(jnp.asarray(pools), mode="int8")
    tq, ts = tf.quantize_kv_paged(torch.from_numpy(pools), mode="int8")
    assert np.array_equal(tq.numpy(), np.asarray(jq)), "quantize_kv_paged"
    assert np.array_equal(ts.numpy(), np.asarray(js)), "page scales"
    for scales in (None, (js, ts)):
        want = np.asarray(jf.dequantize_kv(
            jq, scales=None if scales is None else scales[0]))
        got = tf.dequantize_kv(tq, scales=None if scales is None
                               else scales[1]).numpy()
        assert np.array_equal(got, want), f"dequantize_kv {scales is None}"
    # appends: 4 slots of 3 pages of 8; slot 1 retired, slot 3 at capacity,
    # slot 2 exactly filling its last page; the multi-append crosses pages
    B, pmax, page, hkv = 4, 3, 8, 2
    bt = _table(rng, B, pmax)
    lens = np.array([5, 0, 23, 24], np.int32)
    active = np.array([True, False, True, True])
    kn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    T = 6
    km = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    vm = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    count = np.array([6, 2, 1, 3], np.int32)
    # the scatter is dtype-blind past quantize_kv (bit-equal above): f32
    # and int8 pools
    for pool in ("f32", "int8"):
        z = np.zeros((hkv, B * pmax, page, D), np.float32)
        jk = jnp.asarray(z, _J[pool])
        tk = torch.zeros(z.shape, dtype=_T[pool])
        jr = _jappend(jk, jk, jnp.asarray(bt), jnp.asarray(lens),
                                jnp.asarray(kn), jnp.asarray(vn),
                                active=jnp.asarray(active))
        tr = tf.kv_cache_append(tk.clone(), tk.clone(), torch.from_numpy(bt),
                                torch.from_numpy(lens), torch.from_numpy(kn),
                                torch.from_numpy(vn),
                                active=torch.from_numpy(active))
        for name, a, b in zip(("k", "v", "lens"), tr, jr):
            assert np.array_equal(_tnp(a), _np(b)), f"append {pool} {name}"
        jr = _jappend_multi(
            jk, jk, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(km),
            jnp.asarray(vm), count=jnp.asarray(count),
            active=jnp.asarray(active))
        tr = tf.kv_cache_append_multi(
            tk.clone(), tk.clone(), torch.from_numpy(bt),
            torch.from_numpy(lens), torch.from_numpy(km),
            torch.from_numpy(vm), count=torch.from_numpy(count),
            active=torch.from_numpy(active))
        for name, a, b in zip(("k", "v", "lens"), tr, jr):
            assert np.array_equal(_tnp(a), _np(b)), \
                f"append_multi {pool} {name}"
    assert list(tr[2].numpy()) == [11, 0, 24, 24]
    _bf16_sr(rng)


def _bf16_sr(rng):
    """The stochastic lane in distribution: every value one of x's two bf16
    neighbours, unbiased over many draws, the seed the wrapping int32 sum
    of the rows' bits (a fresh stream per token)."""
    x = (rng.standard_normal((2, 4096)).astype(np.float32)
         * np.float32(1 + 2 ** -10))
    tx = torch.from_numpy(x)
    down = tx.to(torch.bfloat16)
    lo = torch.where(down.float() > tx, torch.nextafter(
        down, torch.tensor(-np.inf, dtype=torch.bfloat16)), down).float()
    hi = torch.where(down.float() < tx, torch.nextafter(
        down, torch.tensor(np.inf, dtype=torch.bfloat16)), down).float()
    got = tf.quantize_kv(tx, torch.bfloat16, mode="bf16_sr").float()
    assert bool(((got == lo) | (got == hi)).all()), "bf16_sr neighbours"
    jgot = _np(_jquant(jnp.asarray(x), jnp.bfloat16, mode="bf16_sr"))
    assert bool(((torch.from_numpy(jgot) == lo)
                 | (torch.from_numpy(jgot) == hi)).all()), "jax bf16_sr"
    bias = float((got - tx).mean() / (hi - lo).mean())
    assert abs(bias) < 0.02, f"bf16_sr bias {bias}"
    bits = x.view(np.int32).astype(np.int64).sum()
    seed = int(((bits + 2 ** 31) % 2 ** 32) - 2 ** 31)
    want = tcp.plain_compress_stochastic(tx, seed)
    assert torch.equal(tf.quantize_kv(tx, torch.bfloat16, mode="bf16_sr"),
                       want), "bf16_sr seed"


def _dyadic(rng, shape, scale):
    """Small integers times a power of two: every projection is exact."""
    return (rng.integers(-3, 4, shape) * scale).astype(np.float32)


def _steps(monkeypatch):
    """The TP decode and prefill steps against the JAX ones."""
    rng = np.random.default_rng(5)
    tp, d_model, H, hkv, page, slots, pmax = 2, 256, 4, 2, 8, 4, 4
    w = [_dyadic(rng, s, 2.0 ** -4) for s in
         ((d_model, H * D), (d_model, hkv * D), (d_model, hkv * D),
          (H * D, d_model))]
    jparams = jdm.DecodeParams(*(jnp.asarray(a) for a in w))
    mesh = jdm.make_decode_mesh(jax.devices()[:tp], tp)
    jstate = jdm.init_decode_state(slots, pmax, page, hkv, D)
    jp, js = jdm.shard_decode(jparams, jstate, mesh)
    jdec = jdm.build_decode_step(mesh, overlap=False, decode_mode="unpaged")
    jpre = jdm.build_prefill_step(mesh, overlap=False,
                                  prefill_mode="unpaged")
    comm = at.Communicator(tp, "cpu")
    tparams = tdm.params_from_jax(jparams, comm)
    arms = {(o, m): tdm.state_from_jax(jstate, "cpu")
            for o in (True, False) for m in ("paged", "unpaged")}
    dec = {k: tdm.build_decode_step(comm, overlap=k[0], decode_mode=k[1])
           for k in arms}
    pre = {k: tdm.build_prefill_step(comm, overlap=k[0], prefill_mode=k[1])
           for k in arms}
    C = 16

    def check(what, jy, js, ys):
        want = np.asarray(jy)
        for k, (y, st) in ys.items():
            case = f"{what} {k}"
            _close(case, y.numpy(), want)
            for name, a, b in zip(tdm.DecodeState._fields, st, js):
                assert np.array_equal(_tnp(a), np.asarray(b)), \
                    f"{case}: {name}"
            if k in arms:
                arms[k] = st

    for slot in (0, 2):
        js = jdm.admit(js, slot)
        for k in arms:
            arms[k] = tdm.admit(arms[k], slot)
    launches = tf.paged_decode_span.launches
    for n, live in enumerate((C, 13)):
        x = _dyadic(rng, (C, d_model), 0.25)
        jy, js = jpre(jp, js, jnp.asarray(x), 0, live=live)
        check(f"prefill chunk {n}", np.asarray(jy)[:live], js,
              {k: (y[:live], st) for k, (y, st) in
               ((k, pre[k](tparams, arms[k], torch.from_numpy(x), 0,
                           live=live)) for k in arms)})
    for n in range(4):
        if n == 3:
            js = jdm.retire(js, 2)
            for k in arms:
                arms[k] = tdm.retire(arms[k], 2)
        x = _dyadic(rng, (slots, d_model), 0.25)
        jy, js = jdec(jp, js, jnp.asarray(x))
        ref = arms[(False, "unpaged")]
        ref = ref._replace(k_pages=ref.k_pages.clone(),
                           v_pages=ref.v_pages.clone())
        ys = {k: dec[k](tparams, arms[k], torch.from_numpy(x))
              for k in arms}
        ys["reference"] = tdm.decode_step_reference(tparams, ref,
                                                    torch.from_numpy(x))
        check(f"decode step {n}", jy, js, ys)
    assert list(np.asarray(js.seq_lens)) == [32, 0, 0, 0]
    ok = np.array([[1, 1, 0, 1], [0, 1, 1, 1], [1, 1, 1, 1]], bool)
    assert tdm.accept_lengths(ok).tolist() == \
        np.asarray(jdm.accept_lengths(ok)).tolist() == [2, 0, 4]
    assert tdm.full_slots(arms[(True, "paged")]) == [0]
    assert tdm.free_slots(arms[(True, "paged")]) == [1, 2, 3]
    # CPU tensors ran the plain versions: no kernel launched
    assert tf.paged_decode_span.launches == launches
    _engage_reasons(monkeypatch, slots, d_model, H, hkv, tp, page, pmax)
    h = tmetrics.snapshot()["histograms"]
    for path in ("decode", "prefill"):
        assert h[f'accl_latency_dispatch_seconds{{path="{path}"}}'][
            "count"] >= 4, path


def _engage_reasons(monkeypatch, slots, d_model, H, hkv, tp, page, pmax):
    """``decode_engage_reasons`` and ``decode_engages`` equal under the
    module defaults of the collective-matmul registers and under the
    session's (an ``ACCL`` sets 256 KiB thresholds)."""
    from accl_tpu.ops import collective_matmul as jcm
    from accl_tpu_torch.ops import collective_matmul as tcm
    for thr in (0, 256 * 1024):
        for mod in (jcm, tcm):
            monkeypatch.setattr(mod, "_OVERLAP_DEFAULT", True)
            monkeypatch.setattr(mod, "_AG_THRESHOLD", thr)
            monkeypatch.setattr(mod, "_RS_THRESHOLD", thr)
            monkeypatch.setattr(mod, "_AG_CLASS_THRESHOLDS", {})
            monkeypatch.setattr(mod, "_RS_CLASS_THRESHOLDS", {})
        for kw in ({}, {"overlap": True}, {"overlap": False},
                   {"kv_dtype": "int8"}, {"prefill_chunk": 16},
                   {"spec_tokens": 3}):
            for shape in ((slots, d_model, H, hkv, D, tp),
                          (7, 64, 8, 4, 128, 2), (32, 6144, 64, 8, 128, 8)):
                case = (thr, shape, kw)
                want = jdm.decode_engage_reasons(*shape, page=page,
                                                 pages_max=pmax, **kw)
                got = tdm.decode_engage_reasons(*shape, page=page,
                                                pages_max=pmax, **kw)
                assert got == want, case
                ov = kw.get("overlap")
                assert tdm.decode_engages(*shape, overlap=ov) == \
                    jdm.decode_engages(*shape, overlap=ov), case


def _config_write_through(accl):
    """A bad serving register raises in both packages; the registers stay
    as they were, and the port's config too."""
    tacc = at.ACCL(world=2, device="cpu")
    good_t, good_j = tacc.config, accl.config
    regs = ("get_flash_decode_mode", "get_flash_prefill_mode",
            "get_kv_cache_dtype", "get_kv_quant_scale")
    for field, bad in (("flash_decode", "ragged"), ("flash_prefill", "x"),
                       ("kv_cache_dtype", "fp4"), ("kv_quant_scale", 0.0),
                       ("kv_quant_scale", -1.0)):
        before = [getattr(m, r)() for m in (tf, jf) for r in regs]
        for acc, good in ((tacc, good_t), (accl, good_j)):
            with pytest.raises(ValueError):
                acc.config = good.replace(**{field: bad})
        assert tacc.config is good_t, field
        accl.config = good_j
        assert [getattr(m, r)() for m in (tf, jf) for r in regs] == before
    for acc, good in ((tacc, good_t), (accl, good_j)):
        acc.config = good.replace(flash_decode="unpaged",
                                  kv_cache_dtype="int8", kv_quant_scale=8.0)
    assert [getattr(tf, r)() for r in regs] == \
        [getattr(jf, r)() for r in regs] == ["unpaged", "paged", "int8", 8.0]
    tacc.config = good_t
    accl.config = good_j
    assert tf.get_kv_quant_scale() == jf.get_kv_quant_scale() == 32.0
    tacc.deinit()


def test_serving_matches_jax(accl, monkeypatch):
    _entry_points()
    _plans_and_declines(monkeypatch)
    _codecs_and_appends()
    _steps(monkeypatch)
    _config_write_through(accl)
    for fn in (tf.paged_decode, tf.paged_decode_span):
        assert fn.launches == 0, fn.__name__
