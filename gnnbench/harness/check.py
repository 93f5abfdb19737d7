"""The comparison that decides ``correct``.

A sample of the window's refreshes, drawn from the seed, is held to the
configuration's plain reference, worked out again from the generated
edges and the weights the driver pushed, on the weights each refresh
was due to see; a refresh answers every node. An answer is a node's
class and that class's probability; its error is

    max(|p_served − p_ref[c_served]|, p_ref_max − p_ref[c_served]) / p_ref_max

so a wrong probability and a class the reference does not rank first
both count.

Numbers compared, each against the cell's limit (``limits/<cell>.json``):

- ``answer_err``: the largest error over the answers compared;
- ``unanswered``: refreshes that failed or never came.

``control=True`` also puts the reference in TF32 in the program's place
(the control that must fail the limit) and reports its ``answer_err``
as ``control_answer_err``; benchmark runs do not compute it.
"""
from __future__ import annotations

import gc

import numpy as np


def entry_errors(p_ref: np.ndarray, classes: np.ndarray,
                 probs: np.ndarray) -> np.ndarray:
    """Per-node error of served (class, probability) pairs against the
    reference's (k, C) probabilities. A class out of range scores 1."""
    classes = np.asarray(classes, dtype=np.int64)
    ok = (classes >= 0) & (classes < p_ref.shape[1])
    rows = np.arange(len(classes))
    p_c = np.where(ok, p_ref[rows, np.where(ok, classes, 0)], 0.0)
    p_max = p_ref.max(axis=1)
    err = np.maximum(np.abs(np.asarray(probs, dtype=np.float64) - p_c),
                     p_max - p_c) / p_max
    return np.where(ok, err, 1.0)


def _served(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A reference put in the program's place: its classes and float32
    probabilities."""
    return p.argmax(axis=1), p.max(axis=1).astype(np.float32)


class Checker:
    def __init__(self, reference, graph, weights: list, device: str,
                 control: bool = False):
        self.ref = reference
        self.graph = graph
        self.device = device
        self.control = control
        self.weights = [[layer["w"] for layer in tree["layers"]]
                        for tree in weights]

    def _probs(self, edges: np.ndarray, weight_set: int):
        import torch

        a = self.ref.adjacency(edges, self.graph.num_nodes, self.device)
        x = torch.as_tensor(self.graph.features, device=self.device)
        w = self.weights[weight_set]
        out = [self.ref.probs(a, x, w).cpu().numpy()]
        if self.control:
            out.append(self.ref.probs(a, x, w, tf32=True).cpu().numpy())
        del a, x
        return out

    def check(self, run) -> dict:
        """The compared numbers of ``run``."""
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()
        unanswered = sum(r.outcome != "completed" for r in run.refreshes)
        worst = worst_c = 0.0
        compared = 0
        sets = sorted({s[1] for s in run.samples})
        for k in sets:
            probs = self._probs(self.graph.edges, k)
            for _, ws, ids, classes, p in run.samples:
                if ws != k:
                    continue
                worst = max(worst, float(entry_errors(
                    probs[0][ids], classes, p).max()))
                compared += 1
                if self.control:
                    c_cls, c_p = _served(probs[1][ids])
                    worst_c = max(worst_c, float(entry_errors(
                        probs[0][ids], c_cls, c_p).max()))
        return self._numbers(worst, worst_c, compared, unanswered)

    def _numbers(self, worst: float, worst_c: float, compared: int,
                 unanswered: int) -> dict:
        out = {"answer_err": worst if compared else float("inf"),
               "unanswered": int(unanswered)}
        if self.control:
            out["control_answer_err"] = worst_c
        out["compared"] = compared
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        good = bool(np.isfinite(value)) and value <= limit
        ok &= good
        table[name] = {"value": value if np.isfinite(value) else None,
                       "limit": limit}
    return ok, table
