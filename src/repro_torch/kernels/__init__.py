"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``fused_ingest`` (K1): packed tokens -> signatures, band values, validity.
* ``sigjaccard.pair_counts`` (K2): per-pair signature agreement counts.
* ``sigjaccard.masked_indexed_pair_counts`` and ``masked_pair_counts``
  (K7): the same counts where a mask is set, for the sharded step;
  ``sigjaccard.pair_estimate`` divides K7's pre-gathered counts by M.
* ``ngram.ngram_hashes`` (K3): packed tokens -> n-gram hashes.
* ``minhash.minhash_signatures`` (K4): n-gram hashes and a mask -> signatures.
* ``bandfold.band_values`` (K5): signatures -> band values.
* ``byte_shingle.byte_token_hashes`` (K6): UTF-8 bytes -> token ids at
  token ends; ``byte_shingle.bytes_to_bands`` chains it with K1.
* ``flash_attention.flash_attention`` (K8): causal, sliding-window GQA
  attention forward, the prefill of the dense LMs.

``ops`` gathers the wrappers under ``repro.kernels.ops``'s names.
Sources live in ``csrc/``; ``build`` compiles them with nvcc at first use.
"""
