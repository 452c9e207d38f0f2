"""Deterministic, checkpointable synthetic data pipeline."""

from repro_torch.data.synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
