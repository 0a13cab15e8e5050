"""Synthetic corpora and the ground-truth cardinality pipeline."""
from repro_torch.data.groundtruth import cardinality_table, eps_grid_for_metric
from repro_torch.data.synthetic import DATASETS, DatasetSpec, load_dataset

__all__ = ["DATASETS", "DatasetSpec", "load_dataset", "cardinality_table",
           "eps_grid_for_metric"]
