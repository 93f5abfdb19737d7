"""The Hopper kernels and their plain PyTorch versions.

``shard_spmm``, ``fused_gnn``, ``dense_engine``, ``seg_gather`` and
``flash_attention`` wrap the CUDA C++ kernels in ``csrc/`` (built at first
use by ``_lib``); ``ref`` holds the plain versions; ``registry`` picks
between them and ``ops`` calls them by op name.
"""
