from repro_torch.serving.api import (Completed, Engine, Expired, Failed,
                                     Outcome, Rejected, Server, Ticket)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.gnn_engine import (GNNServeEngine, NodeRequest,
                                            Prediction)
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig

__all__ = [
    "Server", "Ticket", "Engine", "Outcome",
    "Completed", "Rejected", "Expired", "Failed",
    "SchedulerConfig", "MicroBatchScheduler",
    "ServeEngine", "Request",
    "GNNServeEngine", "NodeRequest", "Prediction",
]
