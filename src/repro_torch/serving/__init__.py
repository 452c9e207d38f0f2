"""Serving substrate of the port: the paged KV cache's host-side state
(:mod:`~repro_torch.serving.kvcache`), the SLO scheduler
(:mod:`~repro_torch.serving.scheduler`) and the continuously batched engine
(:mod:`~repro_torch.serving.engine`)."""
