"""The deterministic data pipeline (port of ``repro.data``, numpy only)."""
from .pipeline import DataIterator, SyntheticLMDataset  # noqa: F401
