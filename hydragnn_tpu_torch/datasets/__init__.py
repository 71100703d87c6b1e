from .loader import GraphDataLoader, dataset_invariants

__all__ = ["GraphDataLoader", "dataset_invariants"]
