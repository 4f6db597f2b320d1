"""The slice end to end: ``accl_tpu_torch.ACCL(world=8, device="cpu")``
against ``accl_tpu.ACCL`` over 8 emulated devices, both on the intra-node
tier (``transport=ICI``), on the same numpy inputs through the host API.

Sizes sit on both sides of the 1 MiB ring-kernel threshold: the flat
latency-tier path, the one-shot program, the VMEM-range ring kernels and
once the segmented kernels (a payload just over 4 MiB staged at the
default segment size). Host results are compared bit-equal: the ring
paths keep the JAX fold order; on the one-shot and flat paths both sides
fold in rank order on these inputs.

The JAX instance is this module's own (never the session ``accl``
fixture), built once and torn down with ``deinit()``.
"""
import json

import jax
import numpy as np
import pytest
import torch

import accl_tpu
from accl_tpu.arithconfig import ArithConfig as JArith
from accl_tpu.config import ACCLConfig as JCfg
from accl_tpu.config import Algorithm as JAlgo
from accl_tpu.config import TransportBackend as JT
from accl_tpu.constants import ACCLError as JACCLError
from accl_tpu.constants import dataType as JdT
from accl_tpu.constants import errorCode as JErr
from accl_tpu.constants import reduceFunction as JrF
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch.ops import registry

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

WORLD = 8
CHUNKED = (1 << 17) * WORLD + 128      # staged > 4 MiB: segmented kernels


@pytest.fixture(scope="module")
def jacc():
    inst = accl_tpu.ACCL(devices=jax.devices()[:WORLD],
                         config=JCfg(transport=JT.ICI))
    yield inst
    inst.deinit()


@pytest.fixture(scope="module")
def tacc():
    inst = at.ACCL(world=WORLD, device="cpu",
                   config=at.ACCLConfig(transport=at.TransportBackend.ICI))
    yield inst
    inst.deinit()


def _data(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _algo(tacc, op: str) -> str:
    """Algorithm of the port's most recent program for ``op``."""
    key = next(k for k in reversed(tacc._programs._cache) if k[0].name == op)
    return next(p for p in key if isinstance(p, at.Algorithm)).value


def _run(acc, op, send_count, recv_count, host, dt, **kw):
    send = acc.create_buffer(send_count, dt, host_data=host)
    recv = acc.create_buffer(recv_count, dt)
    getattr(acc, op)(send, recv, **kw)
    return np.asarray(recv.host)


AR = [(1024, "flat", None), (16384, "xla", None), (1 << 18, "pallas", None),
      (CHUNKED, "pallas", None), (1 << 18, "pallas", "bf16")]


def test_allreduce_matches_jax(jacc, tacc):
    for count, algo, comp in AR:
        x = _data(count, (WORLD, count))
        jkw = dict(count=count, function=JrF.SUM)
        tkw = dict(count=count, function=at.reduceFunction.SUM)
        if comp:
            jkw["compress_dtype"] = JdT.bfloat16
            tkw["compress_dtype"] = at.dataType.bfloat16
        want = _run(jacc, "allreduce", count, count, x, JdT.float32, **jkw)
        got = _run(tacc, "allreduce", count, count, x, at.dataType.float32,
                   **tkw)
        assert _algo(tacc, "allreduce") == algo, (count, comp)
        assert np.array_equal(want, got), (count, comp)
    _odd_world_allreduce()


def _odd_world_allreduce():
    """World 3: AUTO (the one-shot program) and the VMEM-range ring
    kernels, bit-equal to the JAX package."""
    jacc = accl_tpu.ACCL(devices=jax.devices()[:3],
                         config=JCfg(transport=JT.ICI))
    tacc = at.ACCL(world=3, device="cpu",
                   config=at.ACCLConfig(transport=at.TransportBackend.ICI))
    for count, algo in ((4000, None), (3000, "pallas")):
        x = _data(count, (3, count))
        jkw = dict(count=count, function=JrF.SUM)
        tkw = dict(count=count, function=at.reduceFunction.SUM)
        if algo:
            jkw["algorithm"] = JAlgo(algo)
            tkw["algorithm"] = at.Algorithm(algo)
        want = _run(jacc, "allreduce", count, count, x, JdT.float32, **jkw)
        got = _run(tacc, "allreduce", count, count, x, at.dataType.float32,
                   **tkw)
        assert np.array_equal(want, got), ("world 3", count, algo)
    jacc.deinit()
    tacc.deinit()


def test_reduce_scatter_and_allgather_match_jax(jacc, tacc):
    for count, algo in ((1024, "xla"), (1 << 18, "pallas")):
        x = _data(count + 1, (WORLD, WORLD * count))
        want = _run(jacc, "reduce_scatter", WORLD * count, count, x,
                    JdT.float32, count=count, function=JrF.SUM)
        got = _run(tacc, "reduce_scatter", WORLD * count, count, x,
                   at.dataType.float32, count=count,
                   function=at.reduceFunction.SUM)
        assert _algo(tacc, "reduce_scatter") == algo, count
        assert np.array_equal(want, got), count

        x = _data(count + 2, (WORLD, count))
        want = _run(jacc, "allgather", count, WORLD * count, x, JdT.float32,
                    count=count)
        got = _run(tacc, "allgather", count, WORLD * count, x,
                   at.dataType.float32, count=count)
        assert _algo(tacc, "allgather") == algo, count
        assert np.array_equal(want, got), count


def test_host_api_semantics(jacc, tacc):
    """run_async, the INVALID_BUFFER_SIZE check on both packages, payloads
    that stay on the device, the RING window of reduce-scatter, copy,
    combine, write_arithconfig, and the configuration's JSON and
    ``stats()``."""
    count = 4096
    x = _data(7, (WORLD, count))
    send = tacc.create_buffer(count, at.dataType.float32, host_data=x)
    recv = tacc.create_buffer(count, at.dataType.float32)
    req = tacc.allreduce(send, recv, count, at.reduceFunction.MAX,
                         run_async=True)
    assert isinstance(req, at.Request)
    req.wait()
    assert req.test() and req.status == at.requestStatus.COMPLETED
    assert req.get_retcode() == at.errorCode.COLLECTIVE_OP_SUCCESS
    want = _run(jacc, "allreduce", count, count, x, JdT.float32,
                count=count, function=JrF.MAX)
    assert np.array_equal(want, recv.host)

    cases = ((jacc, JdT.float32, JrF.SUM, JErr, JACCLError),
             (tacc, at.dataType.float32, at.reduceFunction.SUM,
              at.errorCode, at.ACCLError))
    for acc, dt, func, err, exc in cases:
        send = acc.create_buffer(16, dt)
        recv = acc.create_buffer(16, dt)
        with pytest.raises(exc) as ei:
            acc.allreduce(send, recv, 17, func)
        assert ei.value.code == err.INVALID_BUFFER_SIZE

    # device-resident operands: no host mirror is ever allocated
    count = 300
    send = tacc.create_buffer(count, at.dataType.float32)
    recv = tacc.create_buffer(count, at.dataType.float32)
    x = torch.from_numpy(_data(9, (WORLD, count)))
    send.device_store(x)
    tacc.allreduce(send, recv, count, at.reduceFunction.SUM,
                   from_device=True, to_device=True)
    assert send._host is None and recv._host is None
    ref = registry.reduce_axis0(x, at.reduceFunction.SUM,
                                at.dataType.float32)
    assert torch.equal(recv.data, ref.expand(WORLD, count))

    # 4-8 MiB of reduce-scatter input selects the RING family on the
    # intra-node tier, as in the JAX package: the same result bit for bit
    count = (4 << 20) // 4 // WORLD
    x = _data(11, (WORLD, WORLD * count))
    want = _run(jacc, "reduce_scatter", WORLD * count, count, x,
                JdT.float32, count=count, function=JrF.SUM,
                algorithm=JAlgo.RING)
    got = _run(tacc, "reduce_scatter", WORLD * count, count, x,
               at.dataType.float32, count=count,
               function=at.reduceFunction.SUM)
    assert _algo(tacc, "reduce_scatter") == "ring"
    assert np.array_equal(want, got)

    _copy_and_combine(jacc, tacc)
    _write_arithconfig_checks(jacc, tacc)
    _config_and_stats(tacc)


def _copy_and_combine(jacc, tacc):
    """copy and combine through both host APIs: bit-equal (combine through
    the plugin lane, NaN and -0 included), the operand dtype check, and the
    lane switch in the program-cache key."""
    count = 777
    x = _data(12, (WORLD, count))
    x[0, :4] = [np.nan, -0.0, 0.0, -np.nan]
    y = _data(13, (WORLD, count))
    y[0, :4] = [1.0, 0.0, -0.0, 2.0]
    outs = []
    for acc, dt, func in ((jacc, JdT.float32, JrF.MAX),
                          (tacc, at.dataType.float32,
                           at.reduceFunction.MAX)):
        a = acc.create_buffer(count, dt, host_data=x)
        b = acc.create_buffer(count, dt, host_data=y)
        r = acc.create_buffer(count, dt)
        acc.combine(count, func, a, b, r)
        c = acc.create_buffer(count, dt)
        acc.copy(a, c, count)
        outs.append((np.array(r.host), np.array(c.host)))
    (jr, jc), (tr, tc) = outs
    assert np.array_equal(jr.view(np.uint32), tr.view(np.uint32))
    assert np.array_equal(jc.view(np.uint32), tc.view(np.uint32))
    assert np.array_equal(tc.view(np.uint32), x.view(np.uint32))
    assert tr.view(np.uint32)[0, 1] == 0      # max(-0, +0) is +0

    a = tacc.create_buffer(8, at.dataType.float32)
    b = tacc.create_buffer(8, at.dataType.bfloat16)
    with pytest.raises(at.ACCLError) as ei:
        tacc.combine(8, at.reduceFunction.SUM, a, b, a)
    assert ei.value.code == at.errorCode.ARITH_ERROR
    with pytest.raises(at.ACCLError) as ei:
        tacc.copy(a, a, 9)
    assert ei.value.code == at.errorCode.INVALID_BUFFER_SIZE
    keys = [k for k in tacc._programs._cache
            if k[0] == at.operation.combine]
    assert keys and all(k[-1] is True for k in keys)
    saved = tacc.config
    try:
        tacc.config = saved.replace(use_pallas=False)
        tacc.combine(8, at.reduceFunction.SUM, a, a, a)
        assert (at.operation.combine, 8, at.dataType.float32,
                at.reduceFunction.SUM, False) in tacc._programs._cache
    finally:
        tacc.config = saved


def _write_arithconfig_checks(jacc, tacc):
    """The three validations of a quantized pair raise the same code in
    both packages; a valid one is registered."""
    for acc, A, dT, err, exc in (
            (jacc, JArith, JdT, JErr, JACCLError),
            (tacc, at.ArithConfig, at.dataType, at.errorCode,
             at.ACCLError)):
        bad = (A(dT.float32, dT.int8, quant_scale=4.0),
               A(dT.float32, dT.int8, arith_is_compressed=False,
                 quant_scale=0.0),
               A(dT.float32, dT.float16, arith_is_compressed=False,
                 quant_scale=4.0))
        for cfg in bad:
            with pytest.raises(exc) as ei:
                acc.write_arithconfig(cfg)
            assert ei.value.code == err.COMPRESSION_NOT_SUPPORTED, cfg
        ok = A(dT.float32, dT.int8, arith_is_compressed=False,
               quant_scale=4.0)
        acc.write_arithconfig(ok)
        assert acc._arith_configs[(dT.float32, dT.int8)] == ok
    from accl_tpu_torch.parallel import hierarchical
    with pytest.raises(ValueError, match="dcn_wire_dtype"):
        tacc.config = tacc.config.replace(dcn_wire_dtype="fp8")
    assert tacc.config.dcn_wire_dtype == "off"
    tacc.config = tacc.config.replace(dcn_wire_dtype="bf16_sr")
    try:
        assert hierarchical.get_dcn_wire_dtype() == "bf16_sr"
    finally:
        tacc.config = tacc.config.replace(dcn_wire_dtype="off")
    assert hierarchical.get_dcn_wire_dtype() == "off"


def _config_and_stats(tacc):
    """A configuration saved by the JAX package loads in the port with equal
    fields, the port's text loads back in the JAX package, and ``stats()``
    round-trips JSON."""
    jcfg = JCfg(transport=JT.ICI, pallas_threshold=2 << 20,
                bidirectional_rings=False, sched_mesh_shape=[2, 4])
    tcfg = at.ACCLConfig.from_json(jcfg.to_json())
    for k, v in json_fields(jcfg).items():
        tv = getattr(tcfg, k)
        assert (tv.value if hasattr(tv, "value") else tv) == \
            (v.value if hasattr(v, "value") else v), k
    assert JCfg.from_json(tcfg.to_json()) == jcfg
    assert at.ACCLConfig.from_json(JCfg().to_json()) == at.ACCLConfig()
    with pytest.raises(ValueError):
        at.ACCLConfig.from_json('{"nope": 1}')
    tacc.config = tacc.config.replace(program_cache_size=512)
    assert tacc.stats()["program_cache"]["max_size"] == 512

    # one call of its own, so the cache holds a program whichever of this
    # module's tests ran before on this worker
    f32 = at.dataType.float32
    tacc.allreduce(tacc.create_buffer(8, f32), tacc.create_buffer(8, f32), 8,
                   at.reduceFunction.SUM)
    st = tacc.stats()
    assert json.loads(json.dumps(st)) == st
    assert st["hwid"]["world_size"] == WORLD
    assert st["config"]["transport"] == "ici"
    pc = st["program_cache"]
    assert 1 <= pc["programs"] <= pc["misses"]


def json_fields(cfg) -> dict:
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
