from .batch import (BucketSpec, GraphBatch, GraphSample, build_neighbor_tables,
                    collate, neighbor_budget_for_dataset,
                    with_neighbor_format)

__all__ = ["BucketSpec", "GraphBatch", "GraphSample", "build_neighbor_tables",
           "collate", "neighbor_budget_for_dataset", "with_neighbor_format"]
