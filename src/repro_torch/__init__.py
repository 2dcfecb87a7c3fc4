"""PyTorch / CUDA port of the MinHash-LSH clinical-note dedup system.

``repro_torch`` mirrors ``repro``'s module names (``core/``, ``kernels/``,
``data/``) and computes the same hashes, signatures, band values,
candidate pairs, similarities and cluster labels bit for bit.  Plain
tensor code is PyTorch; each kernel on the batch pipeline's path is a
hand-written CUDA C++ kernel for Hopper (``kernels/csrc``), built with
``nvcc`` at first use.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise unless the caller passes ``device="cpu"``, where each
kernel wrapper runs its plain PyTorch version.
"""
