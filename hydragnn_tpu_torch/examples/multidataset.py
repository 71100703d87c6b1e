"""Multi-dataset training over member datasets, the port's counterpart
of examples/multidataset/train.py for the members the port reads:

    python -m hydragnn_tpu_torch.examples.multidataset
        [--inputfile examples/multidataset/gfm_energy.json]
        [--multi_model_list OC2020,OC2022] [--limit 200] [--num_epoch N]
        [--batch_size B] [--job-dir DIR] [--device cuda]
        [--rank r --world W --rdzv file:///path | tcp://host:port]

Each member is generated (graphs/synthetic.py `generate_oc20_dataset`,
`generate_oc22_dataset`) under <job-dir>/dataset/<member> unless its
files are there, read with `limit` samples and `max_neighbours` 64
(datasets/atomistic.py `load_oc20`, `load_oc22`) and split
(`split_dataset`); the members' PNA degree histograms are merged
(`merge_pna_deg`). `MultiDatasetLoader(num_shards=W)` assigns each of
the W shards a member in proportion to the members' sizes; rank r of a
W-rank group (`--rank/--world/--rdzv`, or the HYDRAGNN_MASTER_* env of
parallel/mesh.init_distributed) trains on shard r's stream through the
SPMD step (parallel/spmd.py; gradients averaged over the ranks), and
evaluates on its shard of the fixed validation and test loaders. Two
ranks sharing one card take `--backend gloo`. Each member needs a shard
of its own, so one process (one shard) trains one member only, as the
JAX example does on one device.

Not ported: the ANI1x, MPTrj and qm7x members (their readers, ROADMAP
A2) and the GraphStore `--preonly` and DDStore `--ddstore` stages
(ROADMAP A10); each raises before any work.
"""
from __future__ import annotations

import argparse
import json
import os
import types

import torch.distributed as dist

from ..config import build_model_config, gather_deg, update_config
from ..datasets.atomistic import load_oc20, load_oc22
from ..datasets.loader import GraphDataLoader, unstack_batch
from ..datasets.split import split_dataset
from ..graphs.synthetic import generate_oc20_dataset, generate_oc22_dataset
from ..models.create import create_model, data_input_dim
from ..parallel.mesh import get_comm_size_and_rank, init_distributed
from ..parallel.multidataset import MultiDatasetLoader, merge_pna_deg
from ..parallel.spmd import SpmdEvalStep, SpmdTrainStep
from ..train import trainer
from ..train.optimizer import select_optimizer
from ..train.train_step import TrainState, make_eval_step, make_train_step
from ..utils.devices import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(REPO, "examples", "multidataset",
                              "gfm_energy.json")
# the example's member names; the port reads OC2020 and OC2022
KNOWN = ("ANI1x", "MPTrj", "OC2020", "OC2022", "qm7x")
UNPORTED_MEMBERS = ("ANI1x", "MPTrj", "qm7x")
MAX_NEIGHBOURS = 64


def check_members(names) -> None:
    """ValueError for a name the example does not know (its message);
    NotImplementedError naming A2 for a member whose reader the port
    lacks."""
    for name in names:
        if name not in KNOWN:
            raise ValueError(
                f"unknown member dataset '{name}'; known: {KNOWN}")
        if name in UNPORTED_MEMBERS:
            raise NotImplementedError(
                f"member dataset '{name}' is not ported to "
                "hydragnn_tpu_torch yet (ROADMAP A2: its reader); the "
                "port reads OC2020 and OC2022")


def ensure_member(name: str, data_dir: str) -> str:
    """The member's directory under `data_dir`, its files generated
    there when absent."""
    d = os.path.join(data_dir, name.lower())
    if not os.path.isdir(os.path.join(d, "synthetic")):
        (generate_oc20_dataset if name == "OC2020"
         else generate_oc22_dataset)(d)
    return d


def load_member(name: str, data_dir: str, limit: int):
    """A member's samples, read from its directory under `data_dir`."""
    d = os.path.join(data_dir, name.lower())
    read = load_oc20 if name == "OC2020" else load_oc22
    return read(d, limit=limit, max_neighbours=MAX_NEIGHBOURS)


class RankShard:
    """Rank r's shard of a stacked fixed loader (the loader itself for
    one shard)."""

    def __init__(self, loader, rank: int):
        self.loader, self.rank = loader, rank

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            yield unstack_batch(b)[self.rank]


def setup(args) -> types.SimpleNamespace:
    """Everything up to the first step: the group, the members, the
    completed config, the model, the loaders and the steps."""
    if args.preonly or args.ddstore:
        raise NotImplementedError(
            "--preonly (GraphStore stores) and --ddstore (the DDStore data "
            "plane) are not ported to hydragnn_tpu_torch yet (ROADMAP "
            "A10); the members are read directly")
    names = args.multi_model_list.split(",")
    check_members(names)
    device = resolve_device(args.device)
    init_distributed(coordinator=args.rdzv, num_processes=args.world,
                     process_id=args.rank, backend=args.backend,
                     device=device)
    world, rank = get_comm_size_and_rank()
    with open(args.inputfile) as f:
        config = json.load(f)
    train_cfg = config["NeuralNetwork"]["Training"]
    if args.num_epoch is not None:
        train_cfg["num_epoch"] = args.num_epoch
    if args.batch_size is not None:
        train_cfg["batch_size"] = args.batch_size

    data_dir = os.path.join(args.job_dir, "dataset")
    if rank == 0:
        for name in names:
            ensure_member(name, data_dir)
    if dist.is_initialized():
        dist.barrier()      # the other ranks read what rank 0 wrote
    splits, degs = [], []
    for name in names:
        samples = load_member(name, data_dir, args.limit)
        degs.append(gather_deg(samples).tolist())
        splits.append(split_dataset(samples, train_cfg["perc_train"],
                                    False))
    trainsets = [s[0] for s in splits]
    valset = sum((list(s[1]) for s in splits), [])
    testset = sum((list(s[2]) for s in splits), [])
    all_train = sum((list(t) for t in trainsets), [])

    class _WithDeg(list):
        pass
    train_proxy = _WithDeg(all_train)
    train_proxy.pna_deg = merge_pna_deg(degs)
    config = update_config(config, train_proxy, valset, testset)
    mcfg = data_input_dim(build_model_config(config), all_train)

    num_shards = args.num_shards or world
    if num_shards != world:
        raise ValueError(
            f"num_shards={num_shards}: the port runs one shard a rank, and "
            f"the group has {world}")
    batch_size = int(train_cfg["batch_size"])
    if batch_size % num_shards != 0:
        batch_size = num_shards * max(1, batch_size // num_shards)
    loader = MultiDatasetLoader(trainsets, batch_size=batch_size,
                                num_shards=num_shards, seed=args.seed,
                                shard=rank)
    val_loader = RankShard(GraphDataLoader(valset, batch_size,
                                           num_shards=num_shards), rank)
    test_loader = RankShard(GraphDataLoader(testset, batch_size,
                                            num_shards=num_shards), rank)

    model = create_model(mcfg, device=device, seed=args.seed)
    tx = select_optimizer(train_cfg)
    state = TrainState.create(model, tx)
    loss_name = train_cfg.get("loss_function_type", "mae")
    if dist.is_initialized():
        train_step = SpmdTrainStep(model, mcfg, tx, loss_name)
        eval_step = SpmdEvalStep(make_eval_step(model, mcfg, loss_name))
    else:
        train_step = make_train_step(model, mcfg, tx, loss_name)
        eval_step = make_eval_step(model, mcfg, loss_name)
    return types.SimpleNamespace(
        device=device, world=world, rank=rank, names=names, config=config,
        train_cfg=train_cfg, mcfg=mcfg, model=model, state=state,
        loader=loader, val_loader=val_loader, test_loader=test_loader,
        train_step=train_step, eval_step=eval_step, batch_size=batch_size,
        splits=splits, loss_name=loss_name)


def run(args):
    """(state, history, run): `setup`, then `train`."""
    return train(setup(args))


def train(r):
    """(state, history, r): the port's epoch driver (train/trainer.
    train_validate_test) over the rank's streams of a `setup`."""
    dev = r.device
    state, history = trainer.train_validate_test(
        r.train_step, r.eval_step, r.state, r.loader, r.val_loader,
        r.test_loader, num_epochs=int(r.train_cfg["num_epoch"]),
        use_early_stopping=bool(r.train_cfg.get("EarlyStopping", False)),
        verbosity=int(r.config.get("Verbosity", {}).get("level", 0) or 0),
        place_fn=lambda b: b.to(dev))
    if r.rank == 0:
        print(json.dumps({"final_train_loss": history["train_loss"][-1],
                          "final_val_loss": history["val_loss"][-1],
                          "num_datasets": len(r.names),
                          "shard_batch": r.batch_size}), flush=True)
    return state, history, r


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Multi-dataset training (hydragnn_tpu_torch)")
    p.add_argument("--inputfile", default=DEFAULT_CONFIG,
                   help="gfm_energy.json (the default) or another "
                        "examples/multidataset config")
    p.add_argument("--multi_model_list", default="OC2020,OC2022")
    p.add_argument("--limit", type=int, default=200,
                   help="samples per member dataset")
    p.add_argument("--num_shards", type=int, default=None,
                   help="shards of each global batch: one a rank")
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--job-dir", default=".",
                   help="members are generated under <job-dir>/dataset")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--rdzv", default=None,
                   help="the group's init method (file:// or tcp://)")
    p.add_argument("--backend", default=None,
                   help="gloo or nccl (default: nccl on the card)")
    p.add_argument("--preonly", action="store_true",
                   help="not ported (ROADMAP A10)")
    p.add_argument("--ddstore", action="store_true",
                   help="not ported (ROADMAP A10)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
