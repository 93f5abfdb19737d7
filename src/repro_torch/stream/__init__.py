"""repro_torch.stream: mutate-while-serving graphs and train-while-serve.

The port of ``repro.stream``:

  * :class:`~repro_torch.graphs.delta.GraphDelta` mutations flow through
    :meth:`repro_torch.serving.api.Server.mutate` — incremental shard
    patching (``graphs/patch.py``) plus targeted logits-cache
    invalidation, serialized with engine steps so in-flight batches
    finish on the pre-delta snapshot;
  * :class:`StreamTrainer` fine-tunes on neighbor-sampled mini-batches
    drawn from recently mutated neighborhoods and hot-reloads the
    weights through :meth:`repro_torch.serving.api.Server.reload`;
  * :func:`random_delta` generates the mutation workload
    (``launch/stream.py`` drives the whole loop).
"""
from repro_torch.stream.trainer import StreamTrainer
from repro_torch.stream.workload import random_delta

__all__ = ["StreamTrainer", "random_delta"]
