"""Synthetic data for the port (numpy only)."""
from repro_torch.data.pipeline import LMBatcher  # noqa: F401
from repro_torch.data.synthetic import SyntheticLM  # noqa: F401
