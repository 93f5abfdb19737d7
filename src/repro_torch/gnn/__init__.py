"""GNN model zoo specs + layer execution planning (``repro_torch.gnn``)."""
from repro_torch.gnn.executor import (LayerPlan, ModelPlan, clear_plan_cache,
                                      enumerate_layer_plans, plan_cache_stats,
                                      plan_key, plan_layer, plan_model)
from repro_torch.gnn.models import (ARCHS, ZooSpec, build_zoo_graph,
                                    graph_signature, init_params, init_zoo,
                                    params_from_numpy, zoo_forward)

__all__ = ["LayerPlan", "ModelPlan", "plan_model", "plan_layer", "plan_key",
           "enumerate_layer_plans", "plan_cache_stats", "clear_plan_cache",
           "ARCHS", "ZooSpec", "build_zoo_graph", "init_zoo", "zoo_forward",
           "graph_signature", "init_params", "params_from_numpy"]
