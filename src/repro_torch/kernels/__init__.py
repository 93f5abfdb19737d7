"""The Hopper kernels of the main path and their plain PyTorch versions.

``shard_spmm``, ``fused_gnn``, ``dense_engine`` and ``seg_gather`` wrap
the CUDA C++ kernels in ``csrc/`` (built at first use by ``_lib``);
``ref`` holds the plain versions; ``registry`` picks between them.
"""
