"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``fused_ingest`` (K1): packed tokens -> signatures, band values, validity.
* ``sigjaccard.pair_counts`` (K2): per-pair signature agreement counts.

Sources live in ``csrc/``; ``build`` compiles them with nvcc at first use.
"""
