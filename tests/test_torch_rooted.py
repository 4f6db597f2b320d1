"""The rooted collectives of the port (``bcast``, ``scatter``, ``gather``,
``reduce``) against the JAX package's: through both host APIs,
``accl_tpu_torch.ACCL(world=8, device="cpu")`` and ``accl_tpu.ACCL`` over 8
emulated devices on the intra-node tier with 4096-byte segments, and, for
the segmented relays, through the builders (the port's plain kernels
against the JAX package's Pallas kernels in TPU interpret mode), on the
same numpy inputs.

Every family of every op runs at roots 0, 3 and 7 (f32, i32 and bf16 in
turn, SUM and MAX for reduce) at a ragged count, with receive buffers
pre-filled with a pattern that the non-root rows must keep. Tolerance:
bit-equal (raw bits; NaN and +-0 included), except where the JAX package
folds in the XLA runtime's order: the XLA one-shot's MAX (``pmax``) breaks
+-0 ties its own way and drops NaN on the CPU, so there the port is
value-equal off the NaN columns and NaN on them.

The PALLAS cases are the expensive ones (each runs the Pallas interpreter
over 8 devices), so each op runs them at each root once, spread over the
host API (one segment) and the builders (two or three segments, the wires,
NaN and +-0): every relay with C > 1, the gather's at roots 0 and 7 as the
reduce's second phase (two segments and an int8 wire at root 0, a bf16
wire at root 7). Each JAX oracle runs once per module (the ``oracle``
cache). A gather whose send buffer is its receive buffer runs the port's
PALLAS and FLAT against the JAX XLA family. The JAX instance
is this module's own, built once and torn down.
"""
import jax
import jax.numpy as jnp
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
from accl_tpu.parallel import pallas_chunked as jchunk
from conftest import requires_interpret_rdma

import accl_tpu_torch as at
from accl_tpu_torch.parallel import pallas_chunked as tchunk

pytestmark = requires_interpret_rdma
torch.set_num_threads(1)

WORLD = 8
N = 1000                       # ragged: no multiple of 128
SEG = 4096
#: (root, dtype, reduce function) in turn
ROOTS = [(0, "float32", "SUM"), (3, "int32", "MAX"), (7, "bfloat16", "SUM")]
#: the families each op has besides PALLAS
FAMILIES = {"bcast": ("xla", "flat", "tree", "ring"),
            "scatter": ("xla", "flat"),
            "gather": ("xla", "flat", "ring"),
            "reduce": ("xla", "flat", "tree", "ring")}


@pytest.fixture(scope="module")
def pair():
    jacc = accl_tpu.ACCL(devices=jax.devices()[:WORLD],
                         config=JCfg(transport=JT.ICI, segment_size=SEG))
    tacc = at.ACCL(world=WORLD, device="cpu", config=at.ACCLConfig(
        transport=at.TransportBackend.ICI, segment_size=SEG))
    int8 = (JArith(JdT.float32, JdT.int8, arith_is_compressed=False,
                   quant_scale=10.0),
            at.ArithConfig(at.dataType.float32, at.dataType.int8,
                           arith_is_compressed=False, quant_scale=10.0))
    jacc.write_arithconfig(int8[0])
    tacc.write_arithconfig(int8[1])
    yield jacc, tacc
    jacc.deinit()
    tacc.deinit()


@pytest.fixture(scope="module")
def oracle(accl):
    cache = {}
    comm = accl.global_comm()

    def run(name, build, *xs):
        if name not in cache:
            prog = build(comm)
            cache[name] = np.asarray(
                prog(*[jax.device_put(x, comm.sharding()) for x in xs]))
        return cache[name]

    return run


def _data(seed: int, shape, dt: str = "float32", specials: bool = False):
    rng = np.random.default_rng(seed)
    if dt == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if specials:                   # +-0 in most places, NaN in a few
        zero = np.where(rng.random(shape) < 0.5, np.float32(0.0),
                        np.float32(-0.0))
        x = np.where(rng.random(shape) < 0.6, zero, x).astype(np.float32)
        x[rng.integers(0, shape[0], 8), rng.integers(0, shape[1], 8)] = \
            np.nan
        # 16 columns of NaN on every rank, each with its own payload and
        # sign: a fold of two NaNs keeps the first operand's if it is
        # negative, else the second's, so the fold order shows in the bits
        r, c = np.meshgrid(np.arange(shape[0]), np.arange(16), indexing="ij")
        x.view(np.uint32)[:, :16] = np.where(
            (r + c) % 3 == 0, 0xFFC00000, 0x7FC00000) | (r * 97 + c + 1)
    if dt == "bfloat16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
    return x


def _pattern(shape, dt: str) -> np.ndarray:
    """Row r holds -(r+1)/2 (-3(r+1) for int32): what a receive row holds
    before the call."""
    scale = 3 if dt == "int32" else 0.5
    rows = -(np.arange(shape[0]) + 1) * scale
    return np.broadcast_to(rows[:, None], shape).astype(
        np.int32 if dt == "int32" else np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int32 else a.astype(np.float32).view(np.uint32)


def _call(acc, jax_side: bool, op: str, x: np.ndarray, root: int, algo: str,
          dt: str = "float32", func: str = "SUM", comp=None) -> np.ndarray:
    """One host-API call; returns the receive buffer's host rows. A gather's
    or reduce's receive buffer is pre-filled with ``_pattern``."""
    D = JdT if jax_side else at.dataType
    n = x.shape[1]
    kw = {"algorithm": (JAlgo if jax_side else at.Algorithm)(algo)}
    if comp:
        kw["compress_dtype"] = D[comp]

    def buf(count, data=None):
        return acc.create_buffer(count, D[dt], host_data=data)

    if op == "bcast":
        out = buf(n, x)
        acc.bcast(out, n, root, **kw)
    elif op == "scatter":
        out = buf(n // WORLD)
        acc.scatter(buf(n, x), out, n // WORLD, root, **kw)
    elif op == "gather":
        out = buf(n * WORLD, _pattern((WORLD, n * WORLD), dt))
        acc.gather(buf(n, x), out, n, root, **kw)
    else:
        out = buf(n, _pattern((WORLD, n), dt))
        acc.reduce(buf(n, x), out, n, root,
                   (JrF if jax_side else at.reduceFunction)[func], **kw)
    return np.asarray(out.host).astype(
        np.int32 if dt == "int32" else np.float32)


def _check(pair, op, x, root, algo, dt="float32", func="SUM", comp=None,
           exact=True):
    """The port against the JAX package, bit for bit (``exact``) or by
    value off the NaN columns; a gather's or reduce's non-root rows keep
    the pattern."""
    jacc, tacc = pair
    case = (op, algo, root, dt, func, comp)
    want = _call(jacc, True, op, x, root, algo, dt, func, comp)
    got = _call(tacc, False, op, x, root, algo, dt, func, comp)
    if exact:
        assert np.array_equal(_bits(want), _bits(got)), case
    else:
        nan = np.isnan(x).any(0)
        assert np.array_equal(want[:, ~nan], got[:, ~nan]), case
        assert np.isnan(got[root, nan]).all(), case
    if op in ("gather", "reduce"):
        keep = [r for r in range(WORLD) if r != root]
        assert np.array_equal(got[keep], _pattern(got.shape, dt)[keep]), \
            case


def test_rooted_match_jax(pair):
    """Every family of every op at roots 0, 3 and 7 (the XLA one-shot's bf16
    SUM included, which XLA accumulates in f32), the PALLAS family at one
    segment, the wires, and the explicit-family errors."""
    for op, algos in FAMILIES.items():
        for i, (root, dt, func) in enumerate(ROOTS):
            n = N * WORLD if op == "scatter" else N
            x = _data(10 * i + len(op), (WORLD, n), dt)
            for algo in algos:
                _check(pair, op, x, root, algo, dt, func)
    # PALLAS, one segment per block: the host-API side of the relays
    for op, root, dt, comp in (("bcast", 7, "float32", "bfloat16"),
                               ("scatter", 0, "int32", None),
                               ("gather", 3, "int32", None),
                               ("reduce", 7, "float32", "bfloat16")):
        n = N * WORLD if op == "scatter" else N
        _check(pair, op, _data(root, (WORLD, n), dt), root, "pallas", dt,
               comp=comp)
    _wire_cases(pair)
    _aliased_gather(pair)
    _explicit_requests(pair[1])


def _aliased_gather(pair):
    """A gather whose send buffer is its receive buffer, at roots 3 and 0,
    with n a whole segment (1024 f32 at 4096-byte segments), so the PALLAS
    body hands the kernel the root's receive row, whose slot 0 is the
    root's send block: the port's PALLAS and FLAT against the JAX XLA
    family, bit for bit over the whole buffer."""
    jacc, tacc = pair
    n = SEG // 4
    for root in (3, 0):
        x = _data(80 + root, (WORLD, WORLD * n))
        jb = jacc.create_buffer(WORLD * n, JdT.float32, host_data=x)
        jacc.gather(jb, jb, n, root, algorithm=JAlgo.XLA)
        want = np.asarray(jb.host)
        assert np.array_equal(want[root, root * n:(root + 1) * n],
                              x[root, :n]), root
        for algo in ("pallas", "flat"):
            tb = tacc.create_buffer(WORLD * n, at.dataType.float32,
                                    host_data=x)
            tacc.gather(tb, tb, n, root, algorithm=at.Algorithm(algo))
            assert np.array_equal(_bits(want), _bits(tb.host)), \
                ("aliased gather", algo, root)


def _explicit_requests(tacc):
    """A family the op lacks is refused, alltoall runs (chunk r of rank q
    lands at rank r, slot q), a root outside the ranks is refused."""
    f32 = at.dataType.float32
    x = _data(5, (WORLD, 8 * WORLD), "float32")
    s = tacc.create_buffer(8 * WORLD, f32, host_data=x)
    r = tacc.create_buffer(8 * WORLD, f32)
    with pytest.raises(ValueError):
        tacc.scatter(s, r, 8, 0, algorithm=at.Algorithm.RING)
    tacc.alltoall(s, r, 8)
    assert np.array_equal(r.host, x.reshape(WORLD, WORLD, 8).transpose(
        1, 0, 2).reshape(WORLD, -1))
    with pytest.raises(at.ACCLError) as ei:
        tacc.bcast(s, 8, WORLD)
    assert ei.value.code == at.errorCode.CONFIG_ERROR
    tacc.barrier()


def test_rooted_relays_match_jax(pair, oracle):
    """MAX on +-0 / NaN through every reduce family, and the segmented
    relays' plain versions against the JAX package's kernels."""
    _signed_zero_and_nan_max(pair)
    _relay_bodies(oracle)


def _wire_cases(pair):
    """An f32 -> bf16 compress_dtype wire through every non-PALLAS family of
    every op, and the int8 arith config (one rounding per dequantize-and-
    add, as XLA compiles it) through every reduce family and the
    multi-hop bcasts."""
    for op, algos in FAMILIES.items():
        n = N * WORLD if op == "scatter" else N
        x = _data(40 + len(op), (WORLD, n))
        for algo in algos:
            _check(pair, op, x, 3, algo, comp="bfloat16")
    x = _data(50, (WORLD, N)) * 0.5
    for op, algo in (("reduce", "xla"), ("reduce", "flat"),
                     ("reduce", "tree"), ("reduce", "ring"),
                     ("bcast", "tree"), ("bcast", "ring")):
        _check(pair, op, x, 5, algo, comp="int8")


def _signed_zero_and_nan_max(pair):
    """MAX on +-0 and NaN with distinct payloads: FLAT and TREE fold
    ``combine(own, received)``, RING ``combine(received, own)``, PALLAS
    the ring kernel's ``combine(received, local)``, and the NaN bits show
    each order; the XLA one-shot is value-equal off the NaN columns."""
    x = _data(60, (WORLD, N), specials=True)
    for algo in ("flat", "tree", "ring", "pallas"):
        _check(pair, "reduce", x, 3, algo, func="MAX")
    _check(pair, "reduce", x, 3, "xla", func="MAX", exact=False)


#: (op, root, segments per block, dtype, wire): C > 1 for every relay;
#: the reduce's gather phase runs on two segments per block, at root 0
RELAY_CASES = [("bcast", 0, 3, "float32", None),
               ("bcast", 3, 2, "bfloat16", None),
               ("scatter", 3, 2, "bfloat16", None),
               ("scatter", 7, 2, "float32", "bf16"),
               ("reduce", 0, 2, "float32", "int8")]
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": JdT.float32, "bfloat16": JdT.bfloat16}


def _relay_bodies(oracle):
    """The port's plain relays (via its builders) against the JAX package's
    Pallas kernels, at 4096-byte segments and ragged blocks."""
    tcomm = at.Communicator(WORLD, "cpu")
    for op, root, nseg, dt, wire in RELAY_CASES:
        # the relays run in the wire dtype; the reduce's chunk grid in dt
        kdt = torch.bfloat16 if wire == "bf16" and op != "reduce" \
            else _TDT[dt]
        seg_elems = tchunk._geometry(1, kdt, SEG)[2]
        blk = seg_elems * nseg - 9                 # ragged last segment
        assert tchunk._geometry(blk, kdt, SEG)[0] == nseg
        n = blk * WORLD if op == "reduce" else blk
        jar = tar = None
        if wire == "bf16":
            jar = JArith(JdT.float32, JdT.bfloat16, arith_is_compressed=False)
            tar = at.ArithConfig(at.dataType.float32, at.dataType.bfloat16,
                                 arith_is_compressed=False)
        elif wire == "int8":
            jar = JArith(JdT.float32, JdT.int8, arith_is_compressed=False,
                         quant_scale=10.0)
            tar = at.ArithConfig(at.dataType.float32, at.dataType.int8,
                                 arith_is_compressed=False, quant_scale=10.0)
        jb = {"bcast": jchunk.build_chunked_ring_bcast,
              "scatter": jchunk.build_chunked_ring_scatter,
              "reduce": None}[op]
        shape = (WORLD, WORLD * n) if op == "scatter" else (WORLD, n)
        x = _data(70 + nseg, shape, dt,
                  specials=(dt == "float32" and wire is None))
        if op == "reduce":
            x = x * 0.5
            dest = _pattern(shape, dt)
            want = oracle(f"{op}-{root}-{nseg}-{dt}-{wire}",
                          lambda c: jchunk.build_chunked_ring_reduce(
                              c, root, JrF.SUM, _JDT[dt], SEG, arith=jar),
                          x, dest)
            prog = tchunk.build_chunked_ring_reduce(
                tcomm, root, at.reduceFunction.SUM, at.dataType[dt], SEG,
                arith=tar)
            got = prog(torch.from_numpy(x), torch.from_numpy(dest.copy()))
        else:
            want = oracle(f"{op}-{root}-{nseg}-{dt}-{wire}",
                          lambda c: jb(c, root, _JDT[dt], SEG, arith=jar), x)
            prog = getattr(tchunk, f"build_chunked_ring_{op}")(
                tcomm, root, at.dataType[dt], SEG, arith=tar)
            got = prog(torch.from_numpy(x).to(_TDT[dt]))
        assert np.array_equal(_bits(want), _bits(got.float())), \
            (op, root, nseg, dt, wire)
