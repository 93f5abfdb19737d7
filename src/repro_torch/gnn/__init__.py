"""GNN model zoo specs + layer execution planning (``repro_torch.gnn``)."""
from repro_torch.gnn.executor import LayerPlan, ModelPlan, plan_model
from repro_torch.gnn.models import (ARCHS, ZooSpec, graph_signature,
                                    init_params, params_from_numpy)

__all__ = ["LayerPlan", "ModelPlan", "plan_model", "ARCHS", "ZooSpec",
           "graph_signature", "init_params", "params_from_numpy"]
