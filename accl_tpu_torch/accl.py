"""The public host API (counterpart: ``accl_tpu/accl.py``).

One :class:`ACCL` supervises ``world`` ranks, each a row of the ``(world,
n)`` tensors of its buffers on one device: the card unless the caller asks
for the CPU (``device="cpu"``, where every program runs its plain PyTorch
version). A collective call resolves its algorithm (:func:`.parallel.
algorithms.select_plan`), takes its program from the LRU
:class:`.parallel.compiler.ProgramCache` (built on first use), runs it on
the send buffer's device tensor and stores the result in the receive
buffer, syncing host mirrors unless ``from_device``/``to_device`` say the
payload stays on the device. Ported so far: ``allreduce``,
``reduce_scatter`` and ``allgather`` with every algorithm family but
MULTIAXIS; the rooted collectives ``bcast``, ``scatter``, ``gather`` and
``reduce`` with every family the JAX package offers for them (the bcast
relay and the one-hop scatter and gather copies on ``PALLAS``);
``alltoall`` in its XLA, FLAT and PALLAS (one-hop copy kernel) families;
``barrier``; the local
primitives ``copy`` and ``combine``; and ``write_arithconfig``. Send/recv,
sub-communicators and the resilience and observability tiers come with
later slices.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from . import constants
from .arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from .buffer import Buffer
from .communicator import Communicator
from .config import ACCLConfig, Algorithm, TransportBackend
from .constants import ACCLError, dataType, errorCode, operation, \
    reduceFunction
from .obs import metrics as _metrics
from .ops import collective_alltoall as _a2a_ops
from .ops import collective_matmul as _cm_ops
from .models import pipeline as _pp_model
from .ops import flash as _flash_ops
from .ops import pipeline_relay as _pp_relay
from .parallel import algorithms, hierarchical, primitives
from .parallel.compiler import ProgramCache
from .request import Request
from .utils.bringup import detect_backend


class ACCL:
    """Entry point. ``world``: ranks (default: one per visible device of
    the device's type); ``device``: ``"cuda"`` by default, ``"cpu"`` to run
    the plain versions on the host."""

    def __init__(self, world: Optional[int] = None, device=None,
                 config: Optional[ACCLConfig] = None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise ACCLError(errorCode.CONFIG_ERROR,
                            "no CUDA device: pass device='cpu' to run the "
                            "plain versions on the host")
        if world is None:
            world = torch.cuda.device_count() if device.type == "cuda" else 1
        cfg = config or ACCLConfig()
        if cfg.transport is None:
            cfg = cfg.replace(transport=detect_backend(device))
        self._programs = ProgramCache(cfg.program_cache_size)
        self.config = cfg
        self.comms = [Communicator(world, device)]
        self._arith_configs = dict(DEFAULT_ARITH_CONFIG)
        # the once-per-pair fallback warnings are module-global; a new
        # session observes its own misconfiguration again
        algorithms.reset_global_fallback_warnings()
        _cm_ops.reset_fallback_warnings()
        self._metrics_baseline = _metrics.snapshot()

    @property
    def config(self) -> ACCLConfig:
        return self._config

    @config.setter
    def config(self, cfg: ACCLConfig) -> None:
        """Write-through: the registers that steer module-level policy are
        applied on every assignment (a bad ``flash_bwd``, ``flash_decode``,
        ``flash_prefill``, ``kv_cache_dtype``, ``kv_quant_scale``,
        ``dcn_wire_dtype``, ``cmatmul_wire_dtype``, ``pp_schedule`` or
        ``pp_interleave`` raises ValueError naming the register and leaves
        the config as it was)."""
        _flash_ops.set_flash_bwd_mode(cfg.flash_bwd)
        _flash_ops.set_flash_decode_mode(cfg.flash_decode)
        _flash_ops.set_flash_prefill_mode(cfg.flash_prefill)
        _flash_ops.set_kv_cache_dtype(cfg.kv_cache_dtype)
        _flash_ops.set_kv_quant_scale(cfg.kv_quant_scale)
        hierarchical.set_dcn_wire_dtype(cfg.dcn_wire_dtype)
        _cm_ops.set_wire_dtype(cfg.cmatmul_wire_dtype)
        _cm_ops.set_overlap_enabled(cfg.cmatmul_overlap)
        _cm_ops.set_overlap_thresholds(cfg.ag_matmul_threshold,
                                       cfg.rs_matmul_threshold)
        _cm_ops.set_overlap_class_thresholds(
            cfg.ag_matmul_class_thresholds, cfg.rs_matmul_class_thresholds)
        _cm_ops.set_nblock_enabled(cfg.cmatmul_nblock)
        _a2a_ops.set_overlap_enabled(cfg.moe_overlap)
        _a2a_ops.set_overlap_threshold(cfg.a2a_matmul_threshold)
        _a2a_ops.set_dw_overlap_enabled(cfg.moe_dw_overlap)
        _pp_model.set_schedule(cfg.pp_schedule)
        _pp_model.set_interleave(cfg.pp_interleave)
        _pp_model.set_cost_config(cfg)
        _pp_relay.set_overlap_enabled(cfg.pp_overlap)
        self._config = cfg
        self._programs.set_maxsize(cfg.program_cache_size)

    def deinit(self) -> None:
        self._programs.clear()

    @property
    def world_size(self) -> int:
        return self.comms[0].world_size

    @property
    def device(self) -> torch.device:
        return self.comms[0].device

    def parse_hwid(self) -> dict:
        dev = self.device
        return {
            "platform": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "world_size": self.world_size,
            "transport": self.config.transport.value,
            "arith_enabled": self.config.enable_arith,
            "compression_enabled": self.config.enable_compression,
        }

    def create_buffer(self, count: int, dtype: dataType,
                      host_data: Optional[np.ndarray] = None) -> Buffer:
        return Buffer(count, dtype, self.comms[0], host_data=host_data)

    def write_arithconfig(self, cfg: ArithConfig) -> None:
        """Register a datapath policy for a dtype pair (``ACCL::
        write_arithconfig``). A quantized int8 wire, ``ArithConfig(float32,
        int8, quant_scale=s, arith_is_compressed=False)``, sends
        clip(round(x*s)) on every hop and decompresses before any
        arithmetic. On the families that recompress partial sums every hop
        (RING, TREE, FLAT, PALLAS) each partial must satisfy
        ``|partial| <= 127 / quant_scale``; beyond it values clip
        silently."""
        if cfg.quant_scale is not None:
            if cfg.arith_is_compressed:
                raise ACCLError(
                    errorCode.COMPRESSION_NOT_SUPPORTED,
                    "quantized wire pairs must decompress before arithmetic "
                    "(set arith_is_compressed=False): integer sums across "
                    "ranks would overflow the wire dtype")
            if cfg.quant_scale <= 0:
                raise ACCLError(
                    errorCode.COMPRESSION_NOT_SUPPORTED,
                    f"quant_scale must be positive, got {cfg.quant_scale}")
            if cfg.compressed != dataType.int8:
                raise ACCLError(
                    errorCode.COMPRESSION_NOT_SUPPORTED,
                    "quant_scale applies to int8 wire dtypes only; float "
                    "wires are plain casts")
        self._arith_configs[(cfg.uncompressed, cfg.compressed)] = cfg

    # ------------------------------------------------------------------
    # internal op plumbing
    # ------------------------------------------------------------------

    def _check_count(self, buf: Buffer, count: int, what: str) -> None:
        if count > buf.count:
            raise ACCLError(errorCode.INVALID_BUFFER_SIZE,
                            f"{what}: count {count} exceeds buffer count "
                            f"{buf.count}")

    def _arith(self, dt: dataType,
               compress_dtype: Optional[dataType]) -> Optional[ArithConfig]:
        if compress_dtype is None or compress_dtype == dt:
            return self._arith_configs.get((dt, dt))
        cfg = self._arith_configs.get((dt, compress_dtype))
        if cfg is None:
            raise ACCLError(errorCode.COMPRESSION_NOT_SUPPORTED,
                            f"no arith config for ({dt.name}, "
                            f"{compress_dtype.name})")
        if not self.config.enable_compression:
            raise ACCLError(errorCode.COMPRESSION_NOT_SUPPORTED,
                            "compression disabled")
        return cfg

    def _input(self, buf: Buffer, count: int,
               from_device: bool) -> torch.Tensor:
        if not from_device:
            buf.sync_to_device()
        view = buf.data
        return view[:, :count] if count != buf.count else view

    def _store(self, buf: Buffer, count: int, value: torch.Tensor) -> None:
        if count == buf.count:
            buf.device_store(value.contiguous())
        else:
            buf.data[:, :count] = value

    def _finish(self, scenario: operation, out_buf: Buffer, to_device: bool,
                run_async: bool, errors: list) -> Optional[Request]:
        def finalizer(_req: Request) -> None:
            if not to_device:
                out_buf.sync_from_device()

        req = Request(scenario.name, device=self.device, finalizer=finalizer,
                      error_words=errors)
        if run_async:
            return req
        req.wait(timeout=self.config.timeout)
        return None

    def _spec_copy(self, count: int, dtype: dataType):
        comm = self.comms[0]
        return ((operation.copy, count, dtype),
                lambda: primitives.build_copy(comm))

    def _spec_combine(self, count: int, dtype: dataType,
                      function: reduceFunction):
        comm = self.comms[0]
        use_pallas = self.config.use_pallas and self.config.enable_arith
        return ((operation.combine, count, dtype, function, use_pallas),
                lambda: primitives.build_combine(comm, function, dtype,
                                                 use_pallas=use_pallas))

    def _twotier_params(self, comm, algo):
        """(slices x per-slice shape, cross-slice wire dtype) of a TWOTIER
        program: both in its cache key, so a re-tuned ``dcn_wire_dtype``
        builds anew. Only an explicit ``algorithm=TWOTIER`` request reaches
        here (AUTO never resolves the family in this port): the physical
        ``hosts_shape``, else ``factor2d`` (ranks on one card have no host
        boundary), and the session wire register."""
        if algo != Algorithm.TWOTIER:
            return (None, None)
        return (algorithms._twotier_shape(comm, None),
                self.config.dcn_wire_dtype)

    def _spec_allreduce(self, count: int, dtype: dataType,
                        function: reduceFunction, compress_dtype, algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        if arith is not None and not arith.supports(function):
            raise ACCLError(errorCode.ARITH_ERROR, f"{function} unsupported")
        algo, _ = algorithms.select_plan(
            operation.allreduce, count * constants.dtype_size(dtype), comm,
            self.config, algorithm, count=count)
        seg = self.config.segment_size
        bidir = self.config.bidirectional_rings
        on_dcn = self.config.transport == TransportBackend.DCN
        ts, dw = self._twotier_params(comm, algo)
        return ((operation.allreduce, count, dtype, function,
                 compress_dtype, algo, seg, bidir, on_dcn, ts, dw),
                lambda: algorithms.build_allreduce(
                    comm, function, dtype, algo, arith, seg, bidir,
                    on_dcn=on_dcn, mesh_shape=ts, dcn_wire_dtype=dw))

    def _spec_reduce_scatter(self, count: int, dtype: dataType,
                             function: reduceFunction, compress_dtype,
                             algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        if arith is not None and not arith.supports(function):
            raise ACCLError(errorCode.ARITH_ERROR, f"{function} unsupported")
        algo, _ = algorithms.select_plan(
            operation.reduce_scatter,
            count * comm.world_size * constants.dtype_size(dtype), comm,
            self.config, algorithm, count=count * comm.world_size)
        seg = self.config.segment_size
        bidir = self.config.bidirectional_rings
        ts, dw = self._twotier_params(comm, algo)
        return ((operation.reduce_scatter, count, dtype, function,
                 compress_dtype, algo, seg, bidir, ts, dw),
                lambda: algorithms.build_reduce_scatter(
                    comm, function, dtype, algo, arith, seg, bidir,
                    mesh_shape=ts, dcn_wire_dtype=dw))

    def _spec_allgather(self, count: int, dtype: dataType, compress_dtype,
                        algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        algo, _ = algorithms.select_plan(
            operation.allgather, count * constants.dtype_size(dtype), comm,
            self.config, algorithm, count=count)
        seg = self.config.segment_size
        bidir = self.config.bidirectional_rings
        ts, dw = self._twotier_params(comm, algo)
        return ((operation.allgather, count, dtype, compress_dtype, algo,
                 seg, bidir, ts, dw),
                lambda: algorithms.build_allgather(
                    comm, algo, arith, dtype, seg, bidir, mesh_shape=ts,
                    dcn_wire_dtype=dw))

    def _spec_bcast(self, count: int, dtype: dataType, root: int,
                    compress_dtype, algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        algo = algorithms.select(
            operation.bcast, count * constants.dtype_size(dtype), comm,
            self.config, algorithm)
        seg = self.config.segment_size
        return ((operation.bcast, count, dtype, root, compress_dtype, algo,
                 seg),
                lambda: algorithms.build_bcast(comm, root, algo, arith,
                                               dtype, seg))

    def _spec_scatter(self, count: int, dtype: dataType, root: int,
                      compress_dtype, algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        # per-edge payload (each star edge moves `count` elements), the
        # selection convention of gather, bcast and reduce
        algo = algorithms.select(
            operation.scatter, count * constants.dtype_size(dtype), comm,
            self.config, algorithm)
        seg = self.config.segment_size
        return ((operation.scatter, count, dtype, root, compress_dtype, algo,
                 seg),
                lambda: algorithms.build_scatter(comm, root, algo, arith,
                                                 dtype, seg))

    def _flat_fanin(self, algo: Algorithm) -> int:
        """The flat star's fan-in register, in the gather and reduce cache
        keys as in the JAX package (ranks on one device need no throttle,
        so the programs do not read it)."""
        return (self.config.gather_flat_tree_max_fanin
                if algo == Algorithm.FLAT else 0)

    def _spec_gather(self, count: int, dtype: dataType, root: int,
                     compress_dtype, algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        algo = algorithms.select(
            operation.gather, count * constants.dtype_size(dtype), comm,
            self.config, algorithm)
        seg = self.config.segment_size
        return ((operation.gather, count, dtype, root, compress_dtype, algo,
                 self._flat_fanin(algo), seg),
                lambda: algorithms.build_gather(comm, root, algo, arith,
                                                dtype, seg))

    def _spec_reduce(self, count: int, dtype: dataType, root: int,
                     function: reduceFunction, compress_dtype, algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        if arith is not None and not arith.supports(function):
            raise ACCLError(errorCode.ARITH_ERROR, f"{function} unsupported")
        algo = algorithms.select(
            operation.reduce, count * constants.dtype_size(dtype), comm,
            self.config, algorithm, count=count)
        seg = self.config.segment_size
        return ((operation.reduce, count, dtype, root, function,
                 compress_dtype, algo, self._flat_fanin(algo), seg),
                lambda: algorithms.build_reduce(comm, root, function, dtype,
                                                algo, arith, seg))

    def _spec_alltoall(self, count: int, dtype: dataType, compress_dtype,
                       algorithm):
        comm = self.comms[0]
        arith = self._arith(dtype, compress_dtype)
        # per-edge payload: each of the P fused trees moves `count` elements
        algo = algorithms.select(
            operation.alltoall, count * constants.dtype_size(dtype), comm,
            self.config, algorithm)
        seg = self.config.segment_size
        return ((operation.alltoall, count, dtype, compress_dtype, algo, seg),
                lambda: algorithms.build_alltoall(comm, algo, arith, dtype,
                                                  seg))

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self.world_size:
            raise ACCLError(errorCode.CONFIG_ERROR,
                            f"root {root} outside ranks 0.."
                            f"{self.world_size - 1}")

    # ------------------------------------------------------------------
    # primitives: copy / combine
    # ------------------------------------------------------------------

    def copy(self, srcbuf: Buffer, dstbuf: Buffer, count: int,
             from_device: bool = False, to_device: bool = False,
             run_async: bool = False) -> Optional[Request]:
        """Every rank's device copy (``ACCL::copy``)."""
        t0 = _metrics.tick()
        self._check_count(srcbuf, count, "copy src")
        self._check_count(dstbuf, count, "copy dst")
        x = self._input(srcbuf, count, from_device)
        key, build = self._spec_copy(count, srcbuf.dtype)
        prog = self._programs.get(key, build)
        self._store(dstbuf, count, prog(x).to(dstbuf.torch_dtype))
        _metrics.note_call(operation.copy,
                           count * constants.dtype_size(srcbuf.dtype),
                           srcbuf.dtype, key, t0)
        return self._finish(operation.copy, dstbuf, to_device, run_async,
                            [])

    def combine(self, count: int, function: reduceFunction, val1: Buffer,
                val2: Buffer, result: Buffer,
                val1_from_device: bool = False,
                val2_from_device: bool = False, to_device: bool = False,
                run_async: bool = False) -> Optional[Request]:
        """Every rank's elementwise reduce of two buffers (``ACCL::combine``;
        the reduce_ops plugin: the combine kernel on the card)."""
        t0 = _metrics.tick()
        for b, what in ((val1, "combine op0"), (val2, "combine op1"),
                        (result, "combine res")):
            self._check_count(b, count, what)
        if val1.dtype != val2.dtype:
            raise ACCLError(errorCode.ARITH_ERROR,
                            "combine operand dtype mismatch")
        a = self._input(val1, count, val1_from_device)
        b = self._input(val2, count, val2_from_device)
        key, build = self._spec_combine(count, val1.dtype, function)
        prog = self._programs.get(key, build)
        self._store(result, count, prog(a, b).to(result.torch_dtype))
        _metrics.note_call(operation.combine,
                           count * constants.dtype_size(val1.dtype),
                           val1.dtype, key, t0)
        return self._finish(operation.combine, result, to_device, run_async,
                            [])

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def allreduce(self, sendbuf: Buffer, recvbuf: Buffer, count: int,
                  function: reduceFunction, from_device: bool = False,
                  to_device: bool = False, run_async: bool = False,
                  compress_dtype: Optional[dataType] = None,
                  algorithm: Optional[Algorithm] = None
                  ) -> Optional[Request]:
        """Every rank ends with the reduction of every rank's ``count``
        elements."""
        t0 = _metrics.tick()
        self._check_count(sendbuf, count, "allreduce send")
        self._check_count(recvbuf, count, "allreduce recv")
        x = self._input(sendbuf, count, from_device)
        key, build = self._spec_allreduce(count, sendbuf.dtype, function,
                                          compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count, prog(x, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.allreduce,
                           count * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.allreduce, recvbuf, to_device,
                            run_async, errors)

    def reduce_scatter(self, sendbuf: Buffer, recvbuf: Buffer, count: int,
                       function: reduceFunction, from_device: bool = False,
                       to_device: bool = False, run_async: bool = False,
                       compress_dtype: Optional[dataType] = None,
                       algorithm: Optional[Algorithm] = None
                       ) -> Optional[Request]:
        """``count * world`` in, ``count`` out per rank: rank r gets the
        reduction of every rank's chunk r."""
        t0 = _metrics.tick()
        world = self.world_size
        self._check_count(sendbuf, count * world, "reduce_scatter send")
        self._check_count(recvbuf, count, "reduce_scatter recv")
        x = self._input(sendbuf, count * world, from_device)
        key, build = self._spec_reduce_scatter(count, sendbuf.dtype,
                                               function, compress_dtype,
                                               algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count, prog(x, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.reduce_scatter,
                           count * world * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.reduce_scatter, recvbuf, to_device,
                            run_async, errors)

    def bcast(self, buf: Buffer, count: int, root: int,
              from_device: bool = False, to_device: bool = False,
              run_async: bool = False,
              compress_dtype: Optional[dataType] = None,
              algorithm: Optional[Algorithm] = None) -> Optional[Request]:
        """Every rank's ``buf`` ends with the root's first ``count``
        elements (``ACCL::bcast``)."""
        t0 = _metrics.tick()
        self._check_count(buf, count, "bcast")
        self._check_root(root)
        x = self._input(buf, count, from_device)
        key, build = self._spec_bcast(count, buf.dtype, root, compress_dtype,
                                      algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(buf, count, prog(x, errors=errors).to(buf.torch_dtype))
        _metrics.note_call(operation.bcast,
                           count * constants.dtype_size(buf.dtype),
                           buf.dtype, key, t0)
        return self._finish(operation.bcast, buf, to_device, run_async,
                            errors)

    def scatter(self, sendbuf: Buffer, recvbuf: Buffer, count: int, root: int,
                from_device: bool = False, to_device: bool = False,
                run_async: bool = False,
                compress_dtype: Optional[dataType] = None,
                algorithm: Optional[Algorithm] = None) -> Optional[Request]:
        """The root's ``count * world`` elements, chunked: rank r gets chunk
        r (``ACCL::scatter``)."""
        t0 = _metrics.tick()
        world = self.world_size
        self._check_count(sendbuf, count * world, "scatter send")
        self._check_count(recvbuf, count, "scatter recv")
        self._check_root(root)
        x = self._input(sendbuf, count * world, from_device)
        key, build = self._spec_scatter(count, sendbuf.dtype, root,
                                        compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count,
                    prog(x, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.scatter,
                           count * world * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.scatter, recvbuf, to_device, run_async,
                            errors)

    def gather(self, sendbuf: Buffer, recvbuf: Buffer, count: int, root: int,
               from_device: bool = False, to_device: bool = False,
               run_async: bool = False,
               compress_dtype: Optional[dataType] = None,
               algorithm: Optional[Algorithm] = None) -> Optional[Request]:
        """Every rank's ``count`` elements, concatenated in rank order into
        the root's ``recvbuf`` (its device row written in place); every
        other rank's ``recvbuf`` keeps its content (``ACCL::gather``)."""
        t0 = _metrics.tick()
        world = self.world_size
        self._check_count(sendbuf, count, "gather send")
        self._check_count(recvbuf, count * world, "gather recv")
        self._check_root(root)
        x = self._input(sendbuf, count, from_device)
        r = self._input(recvbuf, count * world, True)
        key, build = self._spec_gather(count, sendbuf.dtype, root,
                                       compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count * world,
                    prog(x, r, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.gather,
                           count * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.gather, recvbuf, to_device, run_async,
                            errors)

    def allgather(self, sendbuf: Buffer, recvbuf: Buffer, count: int,
                  from_device: bool = False, to_device: bool = False,
                  run_async: bool = False,
                  compress_dtype: Optional[dataType] = None,
                  algorithm: Optional[Algorithm] = None
                  ) -> Optional[Request]:
        """``count`` in, ``count * world`` out per rank, rank j's block at
        slot j."""
        t0 = _metrics.tick()
        world = self.world_size
        self._check_count(sendbuf, count, "allgather send")
        self._check_count(recvbuf, count * world, "allgather recv")
        x = self._input(sendbuf, count, from_device)
        key, build = self._spec_allgather(count, sendbuf.dtype,
                                          compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count * world,
                    prog(x, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.allgather,
                           count * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.allgather, recvbuf, to_device,
                            run_async, errors)

    def reduce(self, sendbuf: Buffer, recvbuf: Buffer, count: int, root: int,
               function: reduceFunction, from_device: bool = False,
               to_device: bool = False, run_async: bool = False,
               compress_dtype: Optional[dataType] = None,
               algorithm: Optional[Algorithm] = None) -> Optional[Request]:
        """The root's ``recvbuf`` ends with the reduction of every rank's
        ``count`` elements (its device row written in place); every other
        rank's keeps its content (``ACCL::reduce``)."""
        t0 = _metrics.tick()
        self._check_count(sendbuf, count, "reduce send")
        self._check_count(recvbuf, count, "reduce recv")
        self._check_root(root)
        x = self._input(sendbuf, count, from_device)
        r = self._input(recvbuf, count, True)
        key, build = self._spec_reduce(count, sendbuf.dtype, root, function,
                                       compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count,
                    prog(x, r, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.reduce,
                           count * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.reduce, recvbuf, to_device, run_async,
                            errors)

    def alltoall(self, sendbuf: Buffer, recvbuf: Buffer, count: int,
                 from_device: bool = False, to_device: bool = False,
                 run_async: bool = False,
                 compress_dtype: Optional[dataType] = None,
                 algorithm: Optional[Algorithm] = None) -> Optional[Request]:
        """``count * world`` in and out per rank: chunk r of rank q lands at
        rank r, slot q (``ACCL::alltoall``)."""
        t0 = _metrics.tick()
        world = self.world_size
        self._check_count(sendbuf, count * world, "alltoall send")
        self._check_count(recvbuf, count * world, "alltoall recv")
        x = self._input(sendbuf, count * world, from_device)
        key, build = self._spec_alltoall(count, sendbuf.dtype,
                                         compress_dtype, algorithm)
        prog = self._programs.get(key, build)
        errors: list = []
        self._store(recvbuf, count * world,
                    prog(x, errors=errors).to(recvbuf.torch_dtype))
        _metrics.note_call(operation.alltoall,
                           count * world * constants.dtype_size(sendbuf.dtype),
                           sendbuf.dtype, key, t0)
        return self._finish(operation.alltoall, recvbuf, to_device,
                            run_async, errors)

    def barrier(self) -> None:
        """``ACCL::barrier``: wait for every launch on the device, then run
        the zero-payload program (a sum of one token per rank) and wait for
        it."""
        t0 = _metrics.tick()
        comm = self.comms[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prog = self._programs.get((operation.barrier,),
                                  lambda: primitives.build_barrier(comm))
        token = torch.ones(self.world_size, dtype=torch.int32,
                           device=self.device)
        prog(token).item()
        _metrics.note_call(operation.barrier, 0, dataType.int32, None, t0)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """JSON-serializable snapshot: hwid, resolved config, program-cache
        state and the metrics delta since construction."""
        progs, hits, misses = self._programs.stats()
        return {
            "schema": _metrics.SCHEMA_VERSION,
            "schema_version": _metrics.SCHEMA_VERSION,
            "hwid": self.parse_hwid(),
            "config": json.loads(self.config.to_json()),
            "program_cache": {"programs": progs, "hits": hits,
                              "misses": misses,
                              "evictions": self._programs.evictions,
                              "max_size": self._programs.maxsize},
            "metrics": _metrics.delta(self._metrics_baseline),
        }
