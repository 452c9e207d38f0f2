"""Checkpointing of the port: the data-only blob format of snapshots
(:mod:`~repro_torch.checkpoint.serializer`)."""
