"""The port's value types and host plumbing against the JAX package's:
enums, the dtype policy, the configuration schema, the wire codecs, the
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


def test_value_types_match():
    _enums_match()
    _constants_and_dtypes_match()
    _acclerror_message_and_code()
    _arith_configs_match()
    _config_schema_matches()


def test_wire_codecs_and_fold_match():
    for scale in (None, 10.0, 3.0, 16.0):
        _wire_codec_matches(scale)
    for fn in ("SUM", "MAX"):
        _reduce_axis0_matches(fn)


def test_host_plumbing():
    _program_cache_lru_and_counters()
    _metrics_core()
    _buffer_host_mirror_is_lazy()
    _request_on_cpu()
    _bringup_and_defaults()
    _cuda_is_the_default_device()
    _world1_and_compression_errors()
