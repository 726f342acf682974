"""Seeded synthetic data for the port (``data.pipeline``)."""

from repro_torch.data.pipeline import SyntheticImageDataset, SyntheticRequestStream

__all__ = ["SyntheticImageDataset", "SyntheticRequestStream"]
