"""Seeded synthetic data for the port (``data.pipeline``)."""

from repro_torch.data.pipeline import (FileTokenDataset, SyntheticImageDataset,
                                       SyntheticLMDataset,
                                       SyntheticRequestStream)

__all__ = ["FileTokenDataset", "SyntheticImageDataset", "SyntheticLMDataset",
           "SyntheticRequestStream"]
