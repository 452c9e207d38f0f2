"""Serving substrate of the port: the paged KV cache's host-side state and
its spill tier (:mod:`~repro_torch.serving.kvcache`), the SLO scheduler
(:mod:`~repro_torch.serving.scheduler`), the continuously batched engine
(:mod:`~repro_torch.serving.engine`) and, on top of it, the verified batch
tier (:mod:`~repro_torch.serving.batch`): workunits replicated across
cloudlet hosts, validated by bitwise hash quorum, re-issued on churn."""

from repro_torch.serving.batch import (
    BatchJob,
    BatchMaster,
    FaultEvent,
    FaultPlan,
    Workunit,
    WuState,
    make_engine_factory,
    result_digest,
)
from repro_torch.serving.kvcache import RemotePagePool, SpilledPage

__all__ = ["RemotePagePool", "SpilledPage",
           "BatchMaster", "BatchJob", "Workunit", "WuState",
           "FaultPlan", "FaultEvent", "make_engine_factory",
           "result_digest"]
