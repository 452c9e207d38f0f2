"""Serving substrate of the port: the paged KV cache's host-side state and
its spill tier (:mod:`~repro_torch.serving.kvcache`), the SLO scheduler
(:mod:`~repro_torch.serving.scheduler`) and the continuously batched engine
(:mod:`~repro_torch.serving.engine`)."""

from repro_torch.serving.kvcache import RemotePagePool, SpilledPage

__all__ = ["RemotePagePool", "SpilledPage"]
