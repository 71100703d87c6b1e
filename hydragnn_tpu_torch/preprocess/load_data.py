"""Dataset splitting and loader creation (counterpart:
hydragnn_tpu/preprocess/load_data.py: `split_dataset`, `loader_budgets`,
`create_dataloaders` for one shard, fixed-shape or budget-packed, and the
preprocessing knobs' resolution).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..datasets.loader import GraphDataLoader, padded_budgets
# split_dataset lives with the readers that split; it is importable here,
# where the JAX package keeps it
from ..datasets.split import split_dataset  # noqa: F401
from ..graphs.batch import neighbor_budget_for_dataset
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
_UNPORTED_FORMATS = {"XYZ": "A2: the XYZ reader",
                     "pickle": "A10: datasets (the pickle format)",
                     "adios": "A10: datasets (the GraphStore format)"}
_FORMATS = ("LSMS", "unit_test", "CFG")


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
    `datasets.cfgdataset`. The train split carries the reader's min-max
    (`datasets.lsmsdataset.Split`)."""
    check_dataset_knobs(config)
    if config["Dataset"]["format"] == "CFG":
        from ..datasets.cfgdataset import load_cfg_splits
        return load_cfg_splits(config)
    from ..datasets.lsmsdataset import load_lsms_splits
    return load_lsms_splits(config)


def loader_budgets(all_samples, graphs_per_batch: int,
                   neighbor_format: bool = False):
    """(n_node, n_edge, K or None): the padded shapes every batch of the
    run shares — room for `graphs_per_batch` of the largest graphs,
    bucketed by BucketSpec(64) — and the dense layout's K."""
    n_node, n_edge = padded_budgets(all_samples, graphs_per_batch)
    return (n_node, n_edge,
            neighbor_budget_for_dataset(all_samples) if neighbor_format
            else None)


def create_dataloaders(trainset, valset, testset, batch_size: int,
                       neighbor_format: bool = False, packing: bool = False,
                       pack_lookahead: Optional[int] = None,
                       batch_transform=None):
    """One loader per split (seed 0), all three on one batch shape (and
    one K), so each step kind is one CUDA graph; the train loader shuffles
    and drops its last partial batch. Fixed-shape: room for `batch_size`
    of the largest graphs of any split. With `packing`: the pack budget
    `choose_budget` sizes once over all three splits for `batch_size`
    average graphs (`pack_lookahead` its planner window).
    `batch_transform` (DimeNet's triplets) rewrites every batch."""
    all_samples = list(trainset) + list(valset) + list(testset)
    pack_budget = n_node = n_edge = None
    if packing:
        nodes, edges = sample_sizes(all_samples)
        pack_budget = choose_budget(nodes, edges, max(batch_size, 1),
                                    lookahead=pack_lookahead)
        k = (neighbor_budget_for_dataset(all_samples) if neighbor_format
             else None)
    else:
        n_node, n_edge, k = loader_budgets(all_samples, max(batch_size, 1),
                                           neighbor_format)

    def mk(ds, shuffle):
        return GraphDataLoader(ds, batch_size, shuffle=shuffle, n_node=n_node,
                               n_edge=n_edge, neighbor_format=neighbor_format,
                               neighbor_k=k, packing=packing,
                               pack_budget=pack_budget,
                               batch_transform=batch_transform)
    return mk(trainset, True), mk(valset, False), mk(testset, False)
