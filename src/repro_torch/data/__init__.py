"""Datasets for the paper's evaluation (§6.2.1)."""
from repro_torch.data.datasets import DATASETS, load_dataset  # noqa: F401
