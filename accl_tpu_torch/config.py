"""Runtime configuration (counterpart: ``accl_tpu/config.py``).

``ACCLConfig`` keeps every field of the JAX package under the same name and
default, and the same ``to_json``/``from_json`` text, so a configuration
tuned or saved by either package loads in the other. The registers this
port does not read yet (the schedule synthesizer's multi-axis, two-tier and
full-authority knobs, the ZeRO and publication registers, the resilience
timers) are present and inert.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional

from . import constants


class TransportBackend(enum.Enum):
    """The tier the ranks talk over: ``ICI`` for ranks on one node's card(s)
    (the intra-node tier), ``DCN`` for ranks across nodes, ``SIM`` for ranks
    emulated on the CPU."""

    SIM = "sim"
    ICI = "ici"
    DCN = "dcn"


class Algorithm(enum.Enum):
    """Selectable collective algorithm families."""

    AUTO = "auto"
    XLA = "xla"
    RING = "ring"
    TREE = "tree"
    FLAT = "flat"
    HIERARCHICAL = "hier"
    PALLAS = "pallas"
    MULTIAXIS = "multiaxis"
    TWOTIER = "twotier"


@dataclasses.dataclass
class ACCLConfig:
    """Tunable parameters (field names and defaults as in ``accl_tpu``)."""

    max_eager_size: int = constants.DEFAULT_MAX_EAGER_SIZE
    max_rendezvous_size: int = constants.DEFAULT_MAX_RENDEZVOUS_SIZE
    segment_size: int = constants.DEFAULT_SEGMENT_SIZE
    eager_rx_buffer_count: int = 16
    eager_rx_buffer_size: int = 16 * 1024
    bcast_flat_tree_max_ranks: int = 8
    reduce_flat_tree_max_ranks: int = 8
    reduce_flat_tree_max_count: int = 64 * 1024
    gather_flat_tree_max_fanin: int = 8
    # AUTO-selection thresholds, per op in each op's byte convention
    # (allreduce: count bytes; allgather: per-block bytes; reduce_scatter:
    # total input bytes)
    ring_threshold: int = 4 * 1024 * 1024
    hier_threshold: int = 64 * 1024 * 1024
    dcn_hier_threshold: int = 64 * 1024
    ag_ring_threshold: int = 4 * 1024 * 1024
    rs_ring_threshold: int = 4 * 1024 * 1024
    # on the intra-node tier the ring kernels carry these ops from here up
    pallas_threshold: int = 1 * 1024 * 1024
    ag_pallas_threshold: int = 1 * 1024 * 1024
    rs_pallas_threshold: int = 8 * 1024 * 1024
    bcast_pallas_threshold: int = 8 * 1024 * 1024
    gather_pallas_threshold: int = 8 * 1024 * 1024
    scatter_pallas_threshold: int = 8 * 1024 * 1024
    alltoall_pallas_threshold: int = 8 * 1024 * 1024
    reduce_pallas_threshold: int = 8 * 1024 * 1024
    # chunked rings: odd segments rotate the other way round the ring
    bidirectional_rings: bool = True
    timeout: float = 60.0
    rpc_retry_initial_ms: float = 2.0
    rpc_retry_backoff: float = 2.0
    rpc_retry_max_ms: float = 100.0
    rpc_retry_jitter: float = 0.25
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = 20.0
    shard_replicas: bool = False
    enable_arith: bool = True
    enable_compression: bool = True
    use_pallas: bool = True
    cmatmul_overlap: bool = True
    ag_matmul_threshold: int = 256 * 1024
    rs_matmul_threshold: int = 256 * 1024
    ag_matmul_class_thresholds: dict = dataclasses.field(default_factory=dict)
    rs_matmul_class_thresholds: dict = dataclasses.field(default_factory=dict)
    cmatmul_wire_dtype: Optional[str] = None
    cmatmul_nblock: bool = True
    moe_overlap: bool = True
    a2a_matmul_threshold: int = 256 * 1024
    moe_dw_overlap: bool = True
    zero_overlap: bool = True
    zero_prefetch: bool = True
    pp_schedule: str = "auto"
    pp_overlap: bool = True
    pp_interleave: int = 1
    flash_bwd: str = "fused"
    flash_decode: str = "paged"
    flash_prefill: str = "paged"
    spec_decode_tokens: int = 1
    kv_cache_dtype: str = "off"
    kv_quant_scale: float = 32.0
    # below this many bytes the latency tier picks among xla/flat/tree
    latency_tier_threshold: int = 8 * 1024
    sched_synthesis: bool = True
    sched_mesh_shape: Optional[list] = None
    sched_alpha_us: float = 1.0
    sched_beta_gbps: float = 45.0
    sched_dcn_alpha_us: float = 25.0
    sched_dcn_beta_gbps: float = 5.0
    sched_pipeline_chunks: int = 4
    sched_pipeline_startup_us: float = 2.0
    dcn_wire_dtype: str = "off"
    sched_full_authority: bool = False
    sched_online_recal: bool = False
    publish_fused: bool = True
    # compiled-program cache LRU bound (0 disables the bound)
    program_cache_size: int = 1024
    topology_order: bool = True
    algorithm: Algorithm = Algorithm.AUTO
    # None = detect from the device at ACCL construction
    transport: Optional[TransportBackend] = None

    def replace(self, **kw) -> "ACCLConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self, fingerprint: Optional[dict] = None) -> str:
        d = dataclasses.asdict(self)
        d["algorithm"] = self.algorithm.value
        d["transport"] = self.transport.value if self.transport else None
        if fingerprint is not None:
            d["_fingerprint"] = fingerprint
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str,
                  expect_fingerprint: Optional[dict] = None) -> "ACCLConfig":
        """Parse :meth:`to_json` output (either package's). The field set
        must match exactly: unknown and missing keys both raise."""
        d = json.loads(text)
        fp = d.pop("_fingerprint", None)
        if expect_fingerprint is not None and fp != expect_fingerprint:
            raise ValueError(
                f"config fingerprint {fp} does not match this session "
                f"{expect_fingerprint}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown, missing = set(d) - known, known - set(d)
        if unknown or missing:
            raise ValueError(
                f"config schema mismatch: unknown={sorted(unknown)} "
                f"missing={sorted(missing)}")
        d["algorithm"] = Algorithm(d["algorithm"])
        t = d["transport"]
        d["transport"] = TransportBackend(t) if t else None
        return cls(**d)
