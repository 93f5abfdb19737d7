"""GNN model zoo specs + layer execution planning (``repro_torch.gnn``)."""
from repro_torch.gnn.executor import (LayerPlan, ModelPlan, clear_plan_cache,
                                      enumerate_layer_plans, plan_cache_stats,
                                      plan_key, plan_layer, plan_model)
from repro_torch.gnn.models import (ARCHS, ZooSpec, graph_signature,
                                    init_params, params_from_numpy)

__all__ = ["LayerPlan", "ModelPlan", "plan_model", "plan_layer", "plan_key",
           "enumerate_layer_plans", "plan_cache_stats", "clear_plan_cache",
           "ARCHS", "ZooSpec",
           "graph_signature", "init_params", "params_from_numpy"]
