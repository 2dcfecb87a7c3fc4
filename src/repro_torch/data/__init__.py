from repro_torch.data.corpus import (
    accuracy_testset, clustering_testset, inject_near_duplicates,
    make_i2b2_like, perturb,
)

__all__ = [
    "make_i2b2_like", "perturb", "inject_near_duplicates",
    "accuracy_testset", "clustering_testset",
]
