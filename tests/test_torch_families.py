"""The explicit algorithm families of the port (``accl_tpu_torch/parallel/
ring.py``, ``tree.py``, ``hierarchical.py``) against the JAX package's,
through both host APIs: ``accl_tpu_torch.ACCL(world=8, device="cpu")`` and
``accl_tpu.ACCL`` over 8 emulated devices, ``algorithm=`` on every call,
the same numpy inputs.

Tolerances, by what fixes the fold order:
* RING and TREE, the explicit-fold (decompress-before-arith) branch of
  HIERARCHICAL, every MAX and every all-gather: bit-equal on random f32.
* HIERARCHICAL's psum branch and TWOTIER's intra-slice psum fold in the XLA
  runtime's order, the port in rank order: bit-equal on integer-valued f32
  (every partial sum exact), the "bf16" DCN wire included (small integers
  are exact in bf16).
* TWOTIER "bf16_sr": the port rounds stochastically where the JAX package
  off the TPU casts to nearest, so each slice's partial may differ by one
  bf16 ulp: within 2^-7 * sum|x| plus the f32 fold bound; the all-gather's
  every element is one of x's two bf16 neighbours.
* MAX on +-0 / NaN data: bit-equal through FLAT, PALLAS, RING and TREE
  (IEEE maximum: NaN propagates, +0 > -0). The XLA one-shot's ``pmax``
  breaks ties as the XLA runtime does, and on the CPU it drops NaN: there
  the port is value-equal on the columns without NaN and NaN on the
  others, as ``jnp.maximum`` is.

The JAX instance is this module's own, built once and torn down.
"""
import jax
import numpy as np
import pytest
import torch

import accl_tpu
from accl_tpu.arithconfig import ArithConfig as JArith
from accl_tpu.config import ACCLConfig as JCfg
from accl_tpu.config import Algorithm as JAlgo
from accl_tpu.config import TransportBackend as JT
from accl_tpu.constants import dataType as JdT
from accl_tpu.constants import reduceFunction as JrF
from conftest import requires_interpret_rdma

import accl_tpu_torch as at

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

WORLD = 8
N = 1000                                  # ragged: no multiple of 8 * 128


@pytest.fixture(scope="module")
def pair():
    jacc = accl_tpu.ACCL(devices=jax.devices()[:WORLD],
                         config=JCfg(transport=JT.ICI))
    tacc = at.ACCL(world=WORLD, device="cpu",
                   config=at.ACCLConfig(transport=at.TransportBackend.ICI))
    yield jacc, tacc
    jacc.deinit()
    tacc.deinit()


def _data(seed: int, shape, ints: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ints:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _call(acc, jax_side: bool, op: str, x: np.ndarray, algo: str,
          func: str = "SUM", comp=None) -> np.ndarray:
    """One host-API call of ``op`` on ``acc``; returns the receive host."""
    dt = JdT.float32 if jax_side else at.dataType.float32
    n = x.shape[1]
    count = {"allreduce": n, "reduce_scatter": n // WORLD,
             "allgather": n}[op]
    rn = {"allreduce": n, "reduce_scatter": n // WORLD,
          "allgather": n * WORLD}[op]
    send = acc.create_buffer(n, dt, host_data=x)
    recv = acc.create_buffer(rn, dt)
    kw = {"algorithm": (JAlgo if jax_side else at.Algorithm)(algo)}
    if op != "allgather":
        kw["function"] = (JrF if jax_side else at.reduceFunction)[func]
    if comp:
        kw["compress_dtype"] = (JdT if jax_side else at.dataType)[comp]
    getattr(acc, op)(send, recv, count, **kw)
    return np.array(recv.host)


def _both(pair, op, x, algo, **kw):
    jacc, tacc = pair
    return (_call(jacc, True, op, x, algo, **kw),
            _call(tacc, False, op, x, algo, **kw))


def _fold_bound(x: np.ndarray, op: str) -> np.ndarray:
    """The f32 fold's order-independent bound per result element."""
    ax = np.abs(x.astype(np.float64))
    if op == "reduce_scatter":
        s = ax.reshape(WORLD, WORLD, -1).sum(0)
    else:
        s = ax.sum(0, keepdims=True)
    return (WORLD - 1) * 2.0 ** -24 * s, s


def _bf16_neighbours(x: np.ndarray):
    """The two bf16 values around each finite f32 (toward and away from
    zero), as float32."""
    u = x.view(np.uint32) & np.uint32(0xFFFF0000)
    return u.view(np.float32), (u + np.uint32(0x10000)).view(np.float32)


def _exact_cases(pair):
    """Bit-equal on random f32: RING (AR/RS/AG), TREE, HIERARCHICAL's
    explicit fold (bf16 wire) and MAX, TWOTIER's MAX and its all-gather."""
    x = _data(1, (WORLD, N))
    xr = _data(2, (WORLD, N))
    cases = [("allreduce", x, "ring", {}), ("allreduce", x, "tree", {}),
             ("allreduce", x, "ring", {"func": "MAX"}),
             ("allreduce", x, "tree", {"comp": "bfloat16"}),
             ("allreduce", x, "ring", {"comp": "bfloat16"}),
             ("reduce_scatter", xr, "ring", {}),
             ("allgather", x, "ring", {}),
             ("allgather", x, "ring", {"comp": "bfloat16"}),
             ("allreduce", x, "hier", {"comp": "bfloat16"}),
             ("allreduce", x, "hier", {"func": "MAX"}),
             ("allreduce", x, "twotier", {"func": "MAX"}),
             ("reduce_scatter", xr, "twotier", {"func": "MAX"}),
             ("allgather", x, "twotier", {})]
    for op, data, algo, kw in cases:
        want, got = _both(pair, op, data, algo, **kw)
        assert np.array_equal(want, got), (op, algo, kw)


def _integer_valued_cases(pair):
    """The psum branches and TWOTIER at "off" and "bf16": bit-equal where
    every partial sum is exact."""
    jacc, tacc = pair
    x = _data(3, (WORLD, N), ints=True)
    for op, algo in (("allreduce", "hier"), ("allreduce", "twotier"),
                     ("reduce_scatter", "twotier")):
        want, got = _both(pair, op, x, algo)
        assert np.array_equal(want, got), (op, algo)
    for wire in ("bf16", "off"):
        jacc.config = jacc.config.replace(dcn_wire_dtype=wire)
        tacc.config = tacc.config.replace(dcn_wire_dtype=wire)
        for op in ("allreduce", "reduce_scatter", "allgather"):
            want, got = _both(pair, op, x, "twotier")
            assert np.array_equal(want, got), (op, wire)


def _stochastic_wire_cases(pair):
    """TWOTIER "bf16_sr" against the JAX package's deterministic cast."""
    jacc, tacc = pair
    jacc.config = jacc.config.replace(dcn_wire_dtype="bf16_sr")
    tacc.config = tacc.config.replace(dcn_wire_dtype="bf16_sr")
    try:
        x = _data(4, (WORLD, N))
        for op in ("allreduce", "reduce_scatter"):
            want, got = _both(pair, op, x, "twotier")
            bound, s = _fold_bound(x, op)
            err = np.abs(got.astype(np.float64) - want)
            assert (err <= 2.0 ** -7 * s + 2 * bound).all(), op
            assert not np.array_equal(want, got), op   # it did round
        want, got = _both(pair, "allgather", x, "twotier")
        near = _bf16_neighbours(np.tile(x.reshape(1, -1), (WORLD, 1)))
        assert ((want == near[0]) | (want == near[1])).all()
        assert ((got == near[0]) | (got == near[1])).all()
        assert not np.array_equal(want, got)
    finally:
        jacc.config = jacc.config.replace(dcn_wire_dtype="off")
        tacc.config = tacc.config.replace(dcn_wire_dtype="off")


def _quantized_wire_cases(pair):
    """The int8 wire (write_arithconfig) through every family that folds
    it: XLA on the CPU contracts each dequantizing multiply into the add
    that follows it (one rounding), and the port folds the same way."""
    jacc, tacc = pair
    jacc.write_arithconfig(JArith(JdT.float32, JdT.int8,
                                  arith_is_compressed=False,
                                  quant_scale=10.0))
    tacc.write_arithconfig(at.ArithConfig(at.dataType.float32,
                                          at.dataType.int8,
                                          arith_is_compressed=False,
                                          quant_scale=10.0))
    x = _data(5, (WORLD, N)) * 0.5
    for op, algo in (("allreduce", "ring"), ("allreduce", "hier"),
                     ("allreduce", "tree"), ("allreduce", "flat"),
                     ("allreduce", "xla"), ("reduce_scatter", "ring"),
                     ("reduce_scatter", "xla")):
        want, got = _both(pair, op, x, algo, comp="int8")
        assert np.array_equal(want, got), (op, algo)


def _signed_zero_and_nan_max(pair):
    """MAX on +-0 and NaN: IEEE maximum, compared by bits."""
    rng = np.random.default_rng(1)
    x = np.where(rng.random((WORLD, 256)) < 0.5, np.float32(0.0),
                 np.float32(-0.0)).astype(np.float32)
    x[rng.integers(0, WORLD, 8), rng.integers(0, 256, 8)] = np.nan
    for algo in ("flat", "pallas", "ring", "tree"):
        want, got = _both(pair, "allreduce", x, algo, func="MAX")
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32)), \
            algo
    # the XLA one-shot: ties are the XLA runtime's, and on the CPU its pmax
    # drops NaN; the port keeps jnp.maximum's rule there too
    want, got = _both(pair, "allreduce", x, "xla", func="MAX")
    nan = np.isnan(x).any(0)
    assert np.array_equal(want[:, ~nan], got[:, ~nan])
    assert np.isnan(got[:, nan]).all()


def test_families_match_jax(pair):
    _exact_cases(pair)
    _integer_valued_cases(pair)
    _stochastic_wire_cases(pair)
    _quantized_wire_cases(pair)
    _signed_zero_and_nan_max(pair)
