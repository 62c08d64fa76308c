"""Dataset windowing and batching, the 4GI cohort generator."""

from hybrid_ode_torch.data.fourgi_gen import generate_4gi_dataset
from hybrid_ode_torch.data.dataset import (
    GlucoseDataset,
    create_data_arrays,
    split_dataset,
    batch_iterator,
)

__all__ = [
    "generate_4gi_dataset",
    "GlucoseDataset",
    "create_data_arrays",
    "split_dataset",
    "batch_iterator",
]
