"""The port's value types and host plumbing against the JAX package's:
enums, the dtype policy, the configuration schema, the wire codecs, the
plugin lanes (combine, cast, stochastic round, per-leg seeds), the
program cache, the metrics core, buffers, requests and bring-up.

Each test runs a group of checks (the ``_`` helpers below), so the port
adds few items to the tier-1 collection."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu import arithconfig as jarith
from accl_tpu import config as jconfig
from accl_tpu import constants as jconst
from accl_tpu.obs import metrics as jmetrics
from accl_tpu.ops import registry as jreg
from accl_tpu.parallel import hierarchical as jhier

import accl_tpu_torch as at
from accl_tpu_torch import arithconfig as tarith
from accl_tpu_torch import config as tconfig
from accl_tpu_torch import constants as tconst
from accl_tpu_torch.obs import metrics as tmetrics
from accl_tpu_torch.ops import registry as treg
from accl_tpu_torch.parallel import algorithms as talg
from accl_tpu_torch.parallel.compiler import ProgramCache

torch.set_num_threads(1)


def _enums_match():
    for name in ("operation", "reduceFunction", "dataType", "errorCode",
                 "compressionFlags"):
        j, t = getattr(jconst, name), getattr(tconst, name)
        assert {m.name: int(m) for m in j} == \
            {m.name: int(m) for m in t}, name


def _constants_and_dtypes_match():
    for k in ("DEFAULT_MAX_EAGER_SIZE", "DEFAULT_MAX_RENDEZVOUS_SIZE",
              "DEFAULT_SEGMENT_SIZE"):
        assert getattr(tconst, k) == getattr(jconst, k)
    for dt in tconst.dataType:
        if dt == tconst.dataType.none:
            continue
        jdt = jconst.to_jax_dtype(jconst.dataType(int(dt)))
        tdt = tconst.to_torch_dtype(dt)
        assert tconst.dtype_size(dt) == jconst.dtype_size(
            jconst.dataType(int(dt))) == tdt.itemsize
        assert np.dtype(jdt).name == str(tdt).replace("torch.", "")
        assert tconst.from_torch_dtype(tdt) == dt


def _acclerror_message_and_code():
    e = tconst.ACCLError(tconst.errorCode.INVALID_BUFFER_SIZE, "ctx")
    j = jconst.ACCLError(jconst.errorCode.INVALID_BUFFER_SIZE, "ctx")
    assert str(e) == str(j) and int(e.code) == int(j.code)


def _arith_configs_match():
    assert set(tarith.DEFAULT_ARITH_CONFIG) == {
        (tconst.dataType(int(a)), tconst.dataType(int(b)))
        for a, b in jarith.DEFAULT_ARITH_CONFIG}
    for (a, b), j in jarith.DEFAULT_ARITH_CONFIG.items():
        t = tarith.DEFAULT_ARITH_CONFIG[(tconst.dataType(int(a)),
                                         tconst.dataType(int(b)))]
        for prop in ("arith_is_compressed", "decompress_before_arith",
                     "is_compressing", "ratio", "uncompressed_bytes",
                     "compressed_bytes", "quant_scale"):
            assert getattr(t, prop) == getattr(j, prop), prop
    q = tarith.ArithConfig(tconst.dataType.float32, tconst.dataType.int8,
                           arith_is_compressed=False, quant_scale=8.0)
    assert q.decompress_before_arith and q.ratio == 4.0
    assert q.supports(tconst.reduceFunction.MAX)


def _config_schema_matches():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ACCLConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ACCLConfig)}
    assert list(jf) == list(tf)
    for k, v in jf.items():
        tv = tf[k]
        if isinstance(v, jconfig.Algorithm):
            assert tv.value == v.value
        elif v is not dataclasses.MISSING:
            assert tv == v, k
    assert [m.value for m in jconfig.Algorithm] == \
        [m.value for m in tconfig.Algorithm]
    assert [m.value for m in jconfig.TransportBackend] == \
        [m.value for m in tconfig.TransportBackend]


def _wire_codec_matches(scale):
    """compress/decompress of the registry, in jitted JAX (as the programs
    run it) and in torch: bit-equal on the same inputs."""
    import jax
    x = (np.random.default_rng(5).standard_normal(4096) * 9).astype(
        np.float32)
    jdst = jconst.dataType.int8 if scale else jconst.dataType.bfloat16
    tdst = tconst.dataType.int8 if scale else tconst.dataType.bfloat16
    jw = jax.jit(lambda v: jreg.compress(v, jconst.dataType.float32, jdst,
                                         scale))(x)
    jb = jax.jit(lambda v: jreg.decompress(v, jdst, jconst.dataType.float32,
                                           scale))(jw)
    tw = treg.compress(torch.from_numpy(x), tconst.dataType.float32, tdst,
                       scale)
    tb = treg.decompress(tw, tdst, tconst.dataType.float32, scale)
    jw = np.asarray(jw)
    if jw.dtype == jnp.bfloat16:
        jw = jw.astype(np.float32)
    assert np.array_equal(jw, (tw.float() if tw.dtype == torch.bfloat16
                               else tw).numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


def _reduce_axis0_matches(fn):
    x = np.random.default_rng(6).standard_normal((8, 333)).astype(np.float32)
    j = jreg.reduce_axis0(jnp.asarray(x), jconst.reduceFunction[fn],
                          jconst.dataType.float32)
    t = treg.reduce_axis0(torch.from_numpy(x), tconst.reduceFunction[fn],
                          tconst.dataType.float32)
    assert np.array_equal(np.asarray(j), t.numpy())


def _program_cache_lru_and_counters():
    c = ProgramCache(maxsize=2)
    built = []
    for k in ("a", "b", "a", "c", "b"):
        c.get(k, lambda k=k: built.append(k) or k)
    assert built == ["a", "b", "c", "b"]
    assert (c.hits, c.misses, c.evictions) == (1, 4, 2)
    assert c.stats() == (2, 1, 4)
    c.set_maxsize(1)
    assert len(c) == 1 and c.evictions == 3
    c.set_maxsize(0)
    for k in range(10):
        c.get(k, lambda: k)
    assert len(c) == 11


def _metrics_core():
    for n in (0, 1, 1024, 1025, 1 << 20, (1 << 20) + 1, 1 << 26, 1 << 30):
        assert tmetrics.size_bucket(n) == jmetrics.size_bucket(n)
    before = tmetrics.snapshot()
    tmetrics.inc("accl_x_total", 2.0, (("op", "allreduce"),))
    tmetrics.set_gauge("accl_y", 5.0)
    t0 = tmetrics.tick()
    tmetrics.note_call(tconst.operation.allreduce, 4096,
                       tconst.dataType.float32,
                       (tconst.operation.allreduce, at.Algorithm.PALLAS), t0)
    d = tmetrics.delta(before)
    assert d["counters"]['accl_x_total{op="allreduce"}'] == 2.0
    assert d["gauges"]["accl_y"] == 5.0
    key = ('accl_calls_total{op="allreduce",algorithm="pallas",'
           'dtype="float32",bucket="<=4KiB"}')
    assert d["counters"][key] == 1.0
    assert d["histograms"]['accl_dispatch_seconds{op="allreduce"}'][
        "count"] == 1
    tmetrics.disable()
    try:
        assert tmetrics.tick() == 0.0
        tmetrics.inc("accl_x_total")
        assert tmetrics.delta(before)["counters"][
            'accl_x_total{op="allreduce"}'] == 2.0
    finally:
        tmetrics.enable()


def _buffer_host_mirror_is_lazy():
    comm = at.Communicator(4, "cpu")
    b = at.Buffer(10, at.dataType.bfloat16, comm)
    assert b._host is None and b._device is None
    assert b.data.dtype == torch.bfloat16 and b._host is None
    assert b.host.dtype == np.float32 and b.host.shape == (4, 10)
    b.host[:] = 1.5
    b.sync_to_device()
    assert torch.equal(b.data, torch.full((4, 10), 1.5, dtype=torch.bfloat16))
    b.device_store(torch.arange(40.0).reshape(4, 10))
    b.sync_from_device()
    assert np.array_equal(b.host, np.arange(40.0).reshape(4, 10))
    with pytest.raises(ValueError):
        at.Buffer(10, at.dataType.float32, comm, host_data=np.zeros((3, 10)))
    with pytest.raises(ValueError):
        b.device_store(torch.zeros(4, 11))


def _request_on_cpu():
    seen = []
    r = at.Request("allreduce", device="cpu",
                   finalizer=lambda req: seen.append(req.id))
    assert r.test()
    r.wait()
    assert seen == [r.id] and r.status == at.requestStatus.COMPLETED
    assert r.get_duration_ns() >= 0

    def boom(_):
        raise at.ACCLError(at.errorCode.DMA_SIZE_ERROR, "x")

    r = at.Request("allgather", device="cpu", finalizer=boom)
    with pytest.raises(at.ACCLError):
        r.wait()
    assert r.status == at.requestStatus.ERROR
    assert r.get_retcode() == at.errorCode.DMA_SIZE_ERROR

    # a kernel's error word fails the request at wait, before the finalizer
    ok, bad = torch.zeros(1, dtype=torch.int32), torch.ones(1,
                                                            dtype=torch.int32)
    r = at.Request("allreduce", device="cpu", error_words=[ok, ok])
    r.wait()
    assert r.status == at.requestStatus.COMPLETED
    seen.clear()
    r = at.Request("allreduce", device="cpu", error_words=[ok, bad],
                   finalizer=lambda req: seen.append(req.id))
    with pytest.raises(at.ACCLError):
        r.wait()
    assert r.get_retcode() == at.errorCode.KRNL_TIMEOUT_STS_ERROR
    assert seen == []


def _timer_counts_up():
    from accl_tpu.utils.timing import Timer as JTimer
    from accl_tpu_torch.utils.timing import Timer
    t = Timer()
    assert t.elapsed() == 0.0 and t.elapsed_ns() == 0
    t.start()
    t.end()
    assert t.elapsed_ns() >= 0 and t.elapsed() == t.elapsed_ns() / 1e3
    assert [m for m in vars(JTimer) if not m.startswith("__")] == \
        [m for m in vars(Timer) if not m.startswith("__")]


def _bringup_and_defaults():
    from accl_tpu_torch.utils.bringup import detect_backend
    assert detect_backend("cpu") == at.TransportBackend.SIM
    assert detect_backend("cuda") == at.TransportBackend.ICI
    acc = at.ACCL(device="cpu")
    assert acc.world_size == 1 and acc.config.transport == \
        at.TransportBackend.SIM
    for w in range(1, 40):
        assert talg.factor2d(w) == jhier.factor2d(w)


def _cuda_is_the_default_device():
    """No CPU fallback: without a card, the default device refuses."""
    if torch.cuda.is_available():
        return
    with pytest.raises(at.ACCLError) as ei:
        at.ACCL(world=8)
    assert ei.value.code == at.errorCode.CONFIG_ERROR


def _world1_and_compression_errors():
    acc = at.ACCL(world=1, device="cpu")
    s = acc.create_buffer(5, at.dataType.float32,
                          host_data=np.arange(5.0)[None])
    r = acc.create_buffer(5, at.dataType.float32)
    acc.allreduce(s, r, 5, at.reduceFunction.SUM)
    assert np.array_equal(r.host, s.host)
    with pytest.raises(at.ACCLError) as ei:
        acc.allreduce(s, r, 5, at.reduceFunction.SUM,
                      compress_dtype=at.dataType.int8)
    assert ei.value.code == at.errorCode.COMPRESSION_NOT_SUPPORTED


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy or torch array (uint16/uint32)."""
    if isinstance(a, torch.Tensor):
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()]) \
            .numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _specials(n: int, seed: int) -> np.ndarray:
    """Random f32 with NaN, -NaN, +-0, +-inf, subnormals and values past
    the f16 and bf16 ranges."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    sp = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40,
                   -1e-40, 3.4e38, -3.4e38, 65520.0, 65519.0, 6e-8, 1e-45],
                  np.float32)
    x[::7][:len(sp)] = sp
    return x


def _combine_lane_matches():
    """pallas_combine against the JAX Pallas lane (interpret), by bits:
    f32/bf16/f16/i32, SUM and MAX, NaN and +-0 included; donate writes
    operand a."""
    from accl_tpu.ops import reduce_ops as jro
    from accl_tpu_torch.ops import reduce_ops as tro
    # no subnormals here: XLA on the CPU flushes them to zero in max
    a32, b32 = (np.where(np.abs(v) < 1.2e-38, np.float32(0.0), v)
                .astype(np.float32) for v in (_specials(1000, 12),
                                              _specials(1000, 13)))
    b32 = np.roll(b32, 1)                  # a NaN meets a number
    pair = np.arange(0, 1000, 5)
    pair = pair[np.isfinite(a32[pair])]
    b32[pair] = -a32[pair]                 # x + -x and ties of +0 / -0
    ints = np.random.default_rng(14).integers(-2 ** 31, 2 ** 31, (2, 1000),
                                              dtype=np.int64)
    for dt in ("float32", "bfloat16", "float16", "int32"):
        if dt == "int32":
            ja, jb = (ints[0].astype(np.int32), ints[1].astype(np.int32))
        else:
            ja, jb = (jnp.asarray(a32).astype(dt), jnp.asarray(b32).astype(dt))
        ta, tb = (torch.from_numpy(np.asarray(v).view(
            np.int16 if dt in ("bfloat16", "float16") else
            np.asarray(v).dtype).copy()) for v in (ja, jb))
        if dt in ("bfloat16", "float16"):
            ta, tb = ta.view(getattr(torch, dt)), tb.view(getattr(torch, dt))
        for fn in ("SUM", "MAX"):
            want = jro.pallas_combine(ja, jb, jconst.reduceFunction[fn])
            got = tro.pallas_combine(ta, tb, tconst.reduceFunction[fn])
            assert np.array_equal(_bits(want), _bits(got)), (dt, fn)
            acc = ta.clone()
            out = tro.pallas_combine(acc, tb, tconst.reduceFunction[fn],
                                     donate=True)
            assert out is acc and torch.equal(_as_int(out), _as_int(got))
    assert [int(d) for d in tro.PALLAS_DTYPES] == \
        [int(d) for d in jro.PALLAS_DTYPES]
    # a registered lane takes over the registry's combine and cast
    from accl_tpu_torch.ops import compression as tcomp
    f32, bf16 = tconst.dataType.float32, tconst.dataType.bfloat16
    SUM = tconst.reduceFunction.SUM
    treg.register_combine(SUM, f32, tro.make_combine(SUM, f32))
    treg.register_cast(f32, bf16, tcomp.make_cast(f32, bf16))
    try:
        x = torch.from_numpy(a32)
        assert treg._COMBINE_REGISTRY[(SUM, f32)].__name__ == \
            "pallas_sum_float32"
        assert torch.equal(_as_int(treg.combine(x, x, SUM, f32)),
                           _as_int(tro.plain_combine(x, x, SUM)))
        assert torch.equal(_as_int(treg.compress(x, f32, bf16)),
                           _as_int(tcomp.plain_cast(x, torch.bfloat16)))
    finally:
        treg._COMBINE_REGISTRY.clear()
        treg._CAST_REGISTRY.clear()


def _as_int(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _cast_lane_matches():
    """pallas_cast against the JAX Pallas lane (interpret), by bits, for
    the four CAST_PAIRS: NaN keeps XLA's bit patterns, overflow goes to
    inf, subnormals stay."""
    from accl_tpu.ops import compression as jcomp
    from accl_tpu_torch.ops import compression as tcomp
    x = _specials(1000, 15)
    x[1:4] = np.array([0x7FA00000, 0x7F800001, 0xFFC00001],
                      np.uint32).view(np.float32)          # NaN payloads
    narrow = {}
    for dst in ("bfloat16", "float16"):
        want = jcomp.pallas_cast(jnp.asarray(x), getattr(jnp, dst))
        got = tcomp.pallas_cast(torch.from_numpy(x), getattr(torch, dst))
        assert np.array_equal(_bits(want), _bits(got)), dst
        narrow[dst] = (want, got)
    # x[0] and x[7] are the quiet NaN and its negation
    assert list(_bits(narrow["bfloat16"][1])[[0, 7]]) == [0x7FC0, 0xFFC0]
    assert list(_bits(narrow["float16"][1])[[0, 7]]) == [0x7E00, 0xFE00]
    for src, pats in (("bfloat16", [0x7FC0, 0xFFC0, 0x7F81, 0x0001]),
                      ("float16", [0x7E00, 0xFE00, 0x7C01, 0x0001])):
        want, got = narrow[src]
        want = jnp.concatenate([want, jnp.asarray(
            np.array(pats, np.uint16).view(np.int16)).view(want.dtype)])
        got = torch.cat([got, torch.from_numpy(
            np.array(pats, np.uint16).view(np.int16)).view(got.dtype)])
        assert np.array_equal(
            _bits(jcomp.pallas_cast(want, jnp.float32)),
            _bits(tcomp.pallas_cast(got, torch.float32))), src
    assert [(int(a), int(b)) for a, b in tcomp.CAST_PAIRS] == \
        [(int(a), int(b)) for a, b in jcomp.CAST_PAIRS]


def _stochastic_round_properties():
    """The port's SR (its own hash, not the TPU PRNG) against the JAX
    package's lane, which off the TPU is the deterministic cast: every
    output is one of x's two bf16 neighbours, so within one bf16 ulp of
    the JAX output, and over 8 seeds the mean bias is no larger than the
    deterministic cast's (tests/test_collective_matmul.py's TPU bound).
    NaN and inf as in the cast."""
    from accl_tpu.ops import compression as jcomp
    from accl_tpu_torch.ops import compression as tcomp
    x = (np.random.default_rng(16).standard_normal((64, 128))
         .astype(np.float32) * (1.0 + 2 ** -9))
    det = np.asarray(jcomp.pallas_compress_stochastic(
        jnp.asarray(x), jnp.bfloat16, seed=0).astype(jnp.float32))
    lo = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    hi = (lo.view(np.uint32) + np.uint32(0x10000)).view(np.float32)
    outs = []
    for seed in range(8):
        sr = tcomp.pallas_compress_stochastic(torch.from_numpy(x),
                                              torch.bfloat16, seed=seed)
        sr = sr.float().numpy()
        assert ((sr == lo) | (sr == hi)).all(), seed
        assert (np.abs(sr - det) <= np.abs(hi - lo)).all(), seed
        outs.append(sr)
    assert len({o.tobytes() for o in outs}) == 8
    det_bias = abs(float(np.mean(det - x)))
    sr_bias = abs(float(np.mean(np.mean(outs, axis=0) - x)))
    assert sr_bias <= det_bias + 1e-6
    # one seed per row: row r rounds as a lone payload seeded seeds[r]
    seeds = torch.tensor([5, -7, 1 << 30], dtype=torch.int32)
    rows = torch.from_numpy(x[:3])
    whole = tcomp.pallas_compress_stochastic(rows, seed=seeds)
    for r in range(3):
        one = tcomp.pallas_compress_stochastic(rows[r].contiguous(),
                                               seed=int(seeds[r]))
        assert torch.equal(_as_int(whole[r]), _as_int(one)), r
    sp = torch.from_numpy(_specials(128, 17))
    got = _bits(tcomp.pallas_compress_stochastic(sp, seed=3))
    want = _bits(tcomp.plain_cast(sp, torch.bfloat16))
    special = ~torch.isfinite(sp).numpy()
    assert np.array_equal(got[special], want[special])


def _dcn_wire_inertness_matches():
    from accl_tpu_torch.parallel import hierarchical as thier
    assert thier.DCN_WIRE_DTYPES == jhier.DCN_WIRE_DTYPES
    casting = (jarith.DEFAULT_ARITH_CONFIG[(jconst.dataType.float32,
                                            jconst.dataType.bfloat16)],
               tarith.DEFAULT_ARITH_CONFIG[(tconst.dataType.float32,
                                            tconst.dataType.bfloat16)])
    for dt in tconst.dataType:
        jdt = jconst.dataType(int(dt))
        for ja, ta in ((None, None), casting):
            assert thier.dcn_wire_inert(dt, ta) == \
                jhier.dcn_wire_inert(jdt, ja), (dt, ta)


def _derive_seed_matches():
    from accl_tpu.ops import compression as jcomp
    from accl_tpu_torch.ops import compression as tcomp
    bases = [0, 1, -1, 7, -(2 ** 31), 2 ** 31 - 1, 123456789, -987654321]
    for base in bases:
        for step in (0, 1, 2, 17):
            want = int(jcomp.derive_seed(jnp.int32(base), step))
            assert tcomp.derive_seed(base, step) == want, (base, step)
    got = tcomp.derive_seed(torch.tensor(bases, dtype=torch.int32), 1)
    assert got.dtype == torch.int32
    assert got.tolist() == [int(jcomp.derive_seed(jnp.int32(b), 1))
                            for b in bases]
    import jax
    x = np.random.default_rng(18).standard_normal((4, 333)).astype(
        np.float32) * 1e30
    want = [int(jnp.sum(jax.lax.bitcast_convert_type(jnp.asarray(r),
                                                     jnp.int32),
                        dtype=jnp.int32)) for r in x]
    assert tcomp.payload_seed_base(torch.from_numpy(x)).tolist() == want


def test_wire_codecs_and_fold_match():
    """The wire codecs, the folds and the plugin lanes; then the value
    types (enums, constants and dtypes, ACCLError, arith configs, the
    config schema) and the host plumbing, which were an item of their own
    until the tier-1 collection reached its cap. A failing check is
    named."""
    for scale in (None, 10.0, 3.0, 16.0):
        _wire_codec_matches(scale)
    for fn in ("SUM", "MAX"):
        _reduce_axis0_matches(fn)
    for check in (_combine_lane_matches, _cast_lane_matches,
                  _stochastic_round_properties, _derive_seed_matches,
                  _dcn_wire_inertness_matches, _enums_match,
                  _constants_and_dtypes_match, _acclerror_message_and_code,
                  _arith_configs_match, _config_schema_matches,
                  _program_cache_lru_and_counters, _metrics_core,
                  _buffer_host_mirror_is_lazy, _request_on_cpu,
                  _timer_counts_up, _bringup_and_defaults,
                  _cuda_is_the_default_device,
                  _world1_and_compression_errors):
        try:
            check()
        except Exception as e:
            e.add_note(f"in the check {check.__name__}")
            raise
