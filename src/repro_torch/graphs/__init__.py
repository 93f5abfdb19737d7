from repro_torch.graphs.datasets import (DATASETS, TABLE2_DATASETS,
                                         GraphData, GraphProfile,
                                         make_dataset)
from repro_torch.graphs.delta import (GraphDelta, affected_nodes,
                                      apply_to_edge_list,
                                      apply_to_graph_data, seed_nodes,
                                      touched_nodes)
from repro_torch.graphs.patch import PatchResult, PatchState

__all__ = ["DATASETS", "TABLE2_DATASETS", "GraphData", "GraphProfile",
           "make_dataset", "GraphDelta", "affected_nodes",
           "apply_to_edge_list", "apply_to_graph_data", "seed_nodes",
           "touched_nodes", "PatchResult", "PatchState"]
