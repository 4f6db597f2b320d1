"""Schedule synthesis, the α-β pricing part (counterpart:
``accl_tpu/parallel/synth.py``).

Ported so far: the cost model's single-tier parameters
(:meth:`CostModel.from_config`, the ICI and the DCN pair) and
:func:`link_cost_us`, the primitive that consumers outside the plan search
use to price link occupancy (the pipeline-schedule arbiter,
:func:`..models.pipeline.resolve_pp_schedule`). The plan search, the
multi-axis builders and the tiered model come with ROADMAP.md queue 1,
item 8.
"""
from __future__ import annotations

import dataclasses

from ..config import ACCLConfig, TransportBackend


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-transport α-β parameters: ``alpha_us`` is one hop's fixed
    latency (launch + link), ``beta_gbps`` one link direction's
    bandwidth, both from the session config."""

    alpha_us: float
    beta_gbps: float

    @classmethod
    def from_config(cls, cfg: ACCLConfig,
                    transport: TransportBackend) -> "CostModel":
        if transport == TransportBackend.DCN:
            return cls(alpha_us=cfg.sched_dcn_alpha_us,
                       beta_gbps=cfg.sched_dcn_beta_gbps)
        return cls(alpha_us=cfg.sched_alpha_us,
                   beta_gbps=cfg.sched_beta_gbps)


def link_cost_us(cfg: ACCLConfig, transport, nbytes: int,
                 hops: int = 1, channels: int = 1) -> float:
    """Price ``hops`` sequential ring hops of ``nbytes`` each on one link
    with the session's α-β parameters. ``channels=2`` models a
    bidirectional hop (both directions of the link carrying half the
    payload each). ``transport`` accepts the enum or its string value; an
    unknown string raises."""
    if not isinstance(transport, TransportBackend):
        transport = TransportBackend(transport)
    model = CostModel.from_config(cfg, transport)
    # hops pay α each; the payload crosses each hop's link once
    return model.alpha_us * hops + hops * float(nbytes) / (
        max(channels, 1) * model.beta_gbps * 1e3)
