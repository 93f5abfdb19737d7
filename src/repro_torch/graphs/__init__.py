from repro_torch.graphs.datasets import (DATASETS, TABLE2_DATASETS,
                                         GraphData, GraphProfile,
                                         make_dataset)

__all__ = ["DATASETS", "TABLE2_DATASETS", "GraphData", "GraphProfile",
           "make_dataset"]
