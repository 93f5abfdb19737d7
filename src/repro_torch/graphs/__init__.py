from repro_torch.graphs.datasets import (DATASETS, LARGE_DATASETS,
                                         TABLE2_DATASETS, GraphData,
                                         GraphProfile, load, make_dataset)
from repro_torch.graphs.delta import (GraphDelta, affected_nodes,
                                      apply_to_edge_list,
                                      apply_to_graph_data, seed_nodes,
                                      touched_nodes)
from repro_torch.graphs.patch import PatchResult, PatchState
from repro_torch.graphs.sampler import NeighborSampler, SubgraphBatch

__all__ = ["DATASETS", "LARGE_DATASETS", "TABLE2_DATASETS", "GraphData",
           "GraphProfile", "load", "make_dataset", "NeighborSampler",
           "SubgraphBatch", "GraphDelta", "affected_nodes",
           "apply_to_edge_list", "apply_to_graph_data", "seed_nodes",
           "touched_nodes", "PatchResult", "PatchState"]
