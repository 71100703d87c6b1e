"""Dataset splitting and loader creation (counterpart:
hydragnn_tpu/preprocess/load_data.py: `split_dataset`, `loader_budgets`,
`create_dataloaders` for one shard, fixed-shape or budget-packed, and the
preprocessing knobs' resolution).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..datasets.loader import GraphDataLoader, dataset_invariants
# split_dataset lives with the readers that split; it is importable here,
# where the JAX package keeps it
from ..datasets.split import split_dataset  # noqa: F401
from ..graphs.batch import BucketSpec, neighbor_budget_for_dataset
from ..graphs.packing import choose_budget, sample_sizes
from ..utils.envflags import (resolve_preproc_cache_dir,
                              resolve_preproc_workers)


def check_preprocess_knobs(config: Dict) -> None:
    """Raise NotImplementedError, before any file is read, for the
    preprocessing knobs the port lacks: more than one preprocessing
    worker (HYDRAGNN_PREPROC_WORKERS over Training.preprocess_workers; 0
    and 1 both build serially and are accepted) and the preprocessed-sample
    cache (HYDRAGNN_PREPROC_CACHE_DIR over
    Dataset.preprocessed_cache_dir)."""
    workers = resolve_preproc_workers(
        config.get("NeuralNetwork", {}).get("Training"))
    if workers > 1:
        raise NotImplementedError(
            f"{workers} preprocessing workers are not ported to "
            "hydragnn_tpu_torch yet (ROADMAP A10: preprocess/workers.py); "
            "0 or 1 builds the same samples serially")
    if resolve_preproc_cache_dir(config.get("Dataset")):
        raise NotImplementedError(
            "the preprocessed-sample cache is not ported to "
            "hydragnn_tpu_torch yet (ROADMAP A10: preprocess/cache.py)")


# Dataset.format values whose readers are not ported, and their items
_UNPORTED_FORMATS = {"pickle": "A10: datasets (the pickle format)",
                     "adios": "A10: datasets (the GraphStore format)"}
_FORMATS = ("LSMS", "unit_test", "CFG", "XYZ")


def check_dataset_knobs(config: Dict) -> None:
    """Raise before any file is read when the config's data cannot be
    loaded from its files by the port: an unported `Dataset.format`
    (NotImplementedError naming its ROADMAP item), an unknown one
    (ValueError), or an unported preprocessing knob."""
    fmt = (config.get("Dataset") or {}).get("format", "pickle")
    if fmt in _UNPORTED_FORMATS:
        raise NotImplementedError(
            f"Dataset.format {fmt!r} is not ported to hydragnn_tpu_torch "
            f"yet (ROADMAP {_UNPORTED_FORMATS[fmt]})")
    if fmt not in _FORMATS:
        raise ValueError(f"unsupported Dataset.format '{fmt}'")
    check_preprocess_knobs(config)


def load_datasets_from_config(config: Dict):
    """(train, val, test) from the config's own files (counterpart:
    hydragnn_tpu/run_training.py `_load_datasets_from_config`): "LSMS"
    and "unit_test" through `datasets.lsmsdataset`, "CFG" through
    `datasets.cfgdataset`, "XYZ" through `datasets.xyzdataset`. The LSMS
    and CFG train splits carry the reader's min-max
    (`datasets.lsmsdataset.Split`); the XYZ splits are plain lists, as
    in the JAX package."""
    check_dataset_knobs(config)
    if config["Dataset"]["format"] == "CFG":
        from ..datasets.cfgdataset import load_cfg_splits
        return load_cfg_splits(config)
    if config["Dataset"]["format"] == "XYZ":
        from ..datasets.xyzdataset import load_xyz_splits
        return load_xyz_splits(config)
    from ..datasets.lsmsdataset import load_lsms_splits
    return load_lsms_splits(config)


def loader_budgets(all_samples, graphs_per_batch: int,
                   neighbor_format: bool = False, reduce_fn=None):
    """(n_node, n_edge, K or None): the padded shapes every batch of the
    run shares — room for `graphs_per_batch` of the largest graphs,
    bucketed by BucketSpec(64) — and the dense layout's K. `reduce_fn(max
    nodes, max edges, K)` lets a multi-process caller max-reduce the raw
    statistics over the ranks before bucketing
    (`parallel.multiprocess.allreduce_max_int`), so every rank builds the
    same shapes."""
    inv = dataset_invariants(all_samples)
    mx_n, mx_e = inv.max_nodes, inv.max_edges
    k = neighbor_budget_for_dataset(all_samples) if neighbor_format else 0
    if reduce_fn is not None:
        mx_n, mx_e, k = reduce_fn(mx_n, mx_e, k)
    bucket = BucketSpec(multiple=64)
    return (bucket.bucket(mx_n * graphs_per_batch + 1),
            bucket.bucket(mx_e * graphs_per_batch + 1),
            k if neighbor_format else None)


def create_dataloaders(trainset, valset, testset, batch_size: int,
                       neighbor_format: bool = False, packing: bool = False,
                       pack_lookahead: Optional[int] = None,
                       batch_transform=None, n_node: Optional[int] = None,
                       n_edge: Optional[int] = None,
                       neighbor_k: Optional[int] = None,
                       pack_rank: int = 0, pack_nproc: int = 1,
                       num_shards: int = 1):
    """One loader per split (seed 0), all three on one batch shape (and
    one K), so each step kind is one CUDA graph; the train loader shuffles
    and drops its last partial batch. Fixed-shape: room for `batch_size`
    of the largest graphs of any split (for `batch_size / num_shards`
    with `num_shards` stacked shards, the pipeline's microbatches), or
    the `n_node` / `n_edge` / `neighbor_k` a multi-process caller reduced
    over the ranks (`loader_budgets`). With `packing`: the pack budget `choose_budget`
    sizes once over all three splits for `batch_size / num_shards` average
    graphs (`pack_lookahead` its planner window), each rank taking its
    `num_shards` bins a step of the global plan (`pack_rank` of
    `pack_nproc`). `batch_transform`
    (DimeNet's triplets) rewrites every batch."""
    all_samples = list(trainset) + list(valset) + list(testset)
    pack_budget = None
    k = neighbor_k
    if packing:
        nodes, edges = sample_sizes(all_samples)
        pack_budget = choose_budget(
            nodes, edges, max(batch_size // max(num_shards, 1), 1),
            lookahead=pack_lookahead)
        n_node = n_edge = None
    elif n_node is None or n_edge is None:
        n_node, n_edge, kb = loader_budgets(
            all_samples, max(batch_size // max(num_shards, 1), 1),
            neighbor_format)
        k = k if k is not None else kb
    if neighbor_format and k is None:
        k = neighbor_budget_for_dataset(all_samples)

    def mk(ds, shuffle):
        return GraphDataLoader(ds, batch_size, shuffle=shuffle, n_node=n_node,
                               n_edge=n_edge, neighbor_format=neighbor_format,
                               neighbor_k=k, packing=packing,
                               pack_budget=pack_budget,
                               pack_rank=pack_rank, pack_nproc=pack_nproc,
                               batch_transform=batch_transform,
                               num_shards=num_shards)
    return mk(trainset, True), mk(valset, False), mk(testset, False)
