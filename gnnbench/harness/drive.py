"""Drive the program through one cell's traffic: set-up, warm-up, the
measured window and the records the metrics and the check read.

The program under test is ``repro_torch.serving.api.Server`` started
over ``GNNServeEngine``; nothing else of it is called in the window.
Traffic parameters come from the cell's traffic file, sizes from its
configuration file. The load is a closed loop of one client
(``refresh``): each iteration pushes the next weight set through
``Server.reload``, then asks for every node in one request and waits
for it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from gnnbench.harness import gen
from gnnbench.harness.trace import Tracer

MODEL = "m"
GRAPH = "g"
# how long the driver waits for one answer
GRACE_S = 60.0
# warm-up before the window: weight pushes and refreshes, each weight set
# at least once
WARM_REFRESHES = 4
# the closed loop's answers held to the reference: a sample of this many
# refreshes, drawn from the seed
SAMPLED_REFRESHES = 16


@dataclasses.dataclass
class Refresh:
    weight_set: int
    t_reload: float
    t_submit: float
    t_done: float
    outcome: str


@dataclasses.dataclass
class Run:
    """Everything a metric's reader or the check may read of one run."""

    cell: str
    config: dict
    traffic: dict
    seconds: float
    device_kind: str
    t_open: float = 0.0          # the window, perf_counter clock
    t_close: float = 0.0
    setup_s: float = 0.0
    num_nodes: int = 0
    nnz: int = 0                 # Â's nonzeros, self loops included
    dims: list = dataclasses.field(default_factory=list)
    refreshes: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)
    engine: tuple = (None, None)     # GNNServeEngine.stats at open, close
    launches: tuple = (None, None)   # kernels' launch counts at open, close
    trace: object = None
    peaks: object = None
    memory_peak_bytes: int = 0
    # set-up's steps: (step, seconds since the process started) at its end
    setup_steps: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def delta(self, which: str, key: str) -> float:
        a, b = getattr(self, which)
        return b[key] - a[key]


def graph_nnz(edges: np.ndarray, num_nodes: int) -> int:
    """Distinct (src, dst) pairs with the self loops added."""
    keys = gen.unique_sorted(gen.pair_keys(edges))
    loops = (np.arange(num_nodes, dtype=np.int64) << np.int64(32)) \
        | np.arange(num_nodes, dtype=np.int64)
    return int(keys.size + loops.size
               - np.isin(loops, keys, assume_unique=True).sum())


def make_weights(dims: list[int], sets: int, seed: int, device) -> list:
    """``sets`` GCN weight trees {"layers": [{"w": (d, f)}]}, Glorot
    normal, drawn on ``device`` from ``seed`` in one call."""
    import torch

    gen_ = torch.Generator(device=device)
    gen_.manual_seed(seed % 2 ** 64)
    shapes = list(zip(dims[:-1], dims[1:]))
    per_set = sum(d * f for d, f in shapes)
    flat = torch.randn(sets * per_set, generator=gen_, device=device)
    trees, off = [], 0
    for _ in range(sets):
        layers = []
        for d, f in shapes:
            w = flat[off:off + d * f].view(d, f) * (2.0 / (d + f)) ** 0.5
            layers.append({"w": w.contiguous()})
            off += d * f
        trees.append({"layers": layers})
    return trees


def _outcome_name(outcome) -> str:
    return type(outcome).__name__.lower()


class Driver:
    """One run of one cell against the program on ``device``."""

    def __init__(self, cell, seed: int, seconds: float, device: str,
                 trace: bool, t_process: float):
        self.cell = cell
        self.seed = seed
        self.seconds = float(seconds)
        self.device = device
        self.tracing = trace
        self.t_process = t_process
        cfg = cell.config
        self.dims = ([cfg["feature_dim"]]
                     + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1)
                     + [cfg["num_classes"]])
        self.traffic = cell.traffic
        self.graph = None
        self.mark = lambda name: None
        self.weights: list = []

    # -- set-up ----------------------------------------------------------

    def build_graph(self) -> None:
        cfg = self.cell.config
        self.graph = gen.make_graph(cfg["dataset"], seed=self.seed,
                                    scale=cfg["scale"])
        if (self.graph.num_nodes, self.graph.num_edges) != \
                (cfg["num_nodes"], cfg["num_edges"]):
            raise ValueError(
                f"generated {self.graph.num_nodes} nodes / "
                f"{self.graph.num_edges} target edges; the configuration "
                f"states {cfg['num_nodes']} / {cfg['num_edges']}")

    def start_program(self):
        from repro_torch.gnn.models import ZooSpec
        from repro_torch.graphs.datasets import GraphData, GraphProfile
        from repro_torch.serving.api import Server
        from repro_torch.serving.gnn_engine import GNNServeEngine
        from repro_torch.serving.scheduler import SchedulerConfig

        cfg, tr, g = self.cell.config, self.traffic, self.graph
        sets = tr.get("refresh", {}).get("weight_sets", 1)
        self.weights = make_weights(self.dims, sets, self.seed, self.device)
        engine = GNNServeEngine(device=self.device, backend="cuda",
                                max_shard_n=cfg["max_shard_n"],
                                **tr.get("engine", {}))
        profile = GraphProfile(g.name, g.num_nodes, int(g.edges.shape[0]),
                               g.feature_dim, g.num_classes)
        engine.register_graph(GRAPH, GraphData(
            profile, g.edges.copy(), g.features.copy(), g.labels.copy(),
            g.train_mask.copy()))
        engine.register_model(MODEL, ZooSpec(
            cfg["arch"], in_dim=self.dims[0], hidden_dim=cfg["hidden_dim"],
            out_dim=self.dims[-1], num_layers=cfg["num_layers"]),
            params=self.weights[0])
        server = Server(engine, SchedulerConfig(**tr.get("server", {})))
        return server.start()

    # -- the run -----------------------------------------------------------

    def run(self) -> Run:
        import torch

        from repro_torch.kernels import _lib

        run = Run(self.cell.name, self.cell.config, self.traffic,
                  self.seconds, self._device_kind())

        def step(name):
            run.setup_steps.append((name, time.perf_counter()
                                    - self.t_process))

        self.mark = step
        step("start")
        self.build_graph()
        run.num_nodes = self.graph.num_nodes
        run.dims = self.dims
        step("graph generated")
        server = self.start_program()
        step("program started")
        try:
            self._refresh(server, run, warm=True)
            self._sync()
            step("warmed up")
            run.engine = (server.engine.stats, None)
            run.launches = (_lib.launches(), None)
            tracer = Tracer() if self.tracing else None
            if tracer:
                tracer.start()
            run.t_open = time.perf_counter()
            run.setup_s = run.t_open - self.t_process
            self._refresh(server, run, warm=False)
            self._sync()
            run.t_close = time.perf_counter()
            if tracer:
                run.trace = tracer.stop()
            run.engine = (run.engine[0], server.engine.stats)
            run.launches = (run.launches[0], _lib.launches())
        finally:
            server.stop(drain=True)
        if self.device != "cpu":
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        del server
        if self.tracing:        # read only by the traced run's metrics
            run.nnz = graph_nnz(self.graph.edges, self.graph.num_nodes)
        return run

    def _device_kind(self) -> str:
        import torch

        if self.device == "cpu":
            return "cpu"
        return torch.cuda.get_device_name(0)

    def _sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    # -- closed loop: weight pushes, each followed by a full refresh -----

    def _refresh(self, server, run: Run, *, warm: bool) -> None:
        from repro_torch.serving.gnn_engine import NodeRequest

        all_ids = np.arange(self.graph.num_nodes, dtype=np.int64)
        keep = SAMPLED_REFRESHES
        pick = np.random.default_rng([self.seed, 2])
        t_end = time.perf_counter() + self.seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if i >= WARM_REFRESHES if warm else t0 >= t_end:
                return
            k = i % len(self.weights)
            params = self.weights[k]
            server.reload(lambda e, p=params: e.reload_params(MODEL, p))
            t1 = time.perf_counter()
            ticket = server.submit(NodeRequest(GRAPH, all_ids, MODEL))
            try:
                outcome = ticket.result(timeout_s=GRACE_S)
            except TimeoutError:
                outcome = None
            t2 = time.perf_counter()
            name = "missing" if outcome is None else _outcome_name(outcome)
            if not warm:
                run.refreshes.append(Refresh(k, t0, t1, t2, name))
                if name == "completed":
                    pred = outcome.value
                    item = (i, k, pred.node_ids, pred.classes, pred.probs)
                    # reservoir sample of the answers, drawn from the seed
                    if len(run.samples) < keep:
                        run.samples.append(item)
                    else:
                        j = int(pick.integers(0, i + 1))
                        if j < keep:
                            run.samples[j] = item
            if name != "completed":
                return
            if warm and i == 0:
                self.mark("first refresh (compile, index, kernels)")
            i += 1
