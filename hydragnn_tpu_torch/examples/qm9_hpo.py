"""The QM9 hyperparameter search, the port's counterpart of
examples/qm9_hpo/qm9_hpo.py and its common.py, with its command line:

    python -m hydragnn_tpu_torch.examples.qm9_hpo [--num_trials 10]
        [--num_samples 200] [--trial_epochs 4]
        [--log_path hpo_results.json] [--device cuda]

It searches `SPACE` (model type, width, depth, head depth and width)
over examples/qm9_hpo/qm9.json at its published widths, each trial a
`run_training` of `trial_epochs` epochs in this process, through
`utils.hpo.search`: optuna's TPE where optuna is installed, else the
in-tree CBO (utils/bayes_opt.py). A failed trial scores inf (the
reference's "F"). The molecules are `graphs.synthetic.qm9_molecules`;
hpo_results.json has the JAX package's layout ({"best", "history"}).

The config's `Visualization.create_plots` is dropped from each trial:
the port has no Visualizer yet (ROADMAP A10), and the objective does not
read the plots. The trials train on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os

HERE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "qm9_hpo")

# the reference's search space (qm9_optuna.py:52-58), bounded as the JAX
# package bounds it
SPACE = {
    "model_type": ["EGNN", "PNA", "SchNet"],
    "hidden_dim": (16, 64),
    "num_conv_layers": (1, 5),
    "num_headlayers": (1, 3),
    "dim_headlayer": (16, 64),
}


def load_base_config(path: str = os.path.join(HERE, "qm9.json")) -> dict:
    """The example's JSON config, read as a file."""
    with open(path) as f:
        return json.load(f)


def load_splits(num_samples: int, base_config: dict, seed: int = 0):
    """(train, val, test) of `num_samples` synthetic QM9-style molecules
    at the config's radius and neighbour cap."""
    from ..graphs.synthetic import qm9_molecules
    from ..preprocess.load_data import split_dataset
    arch = base_config["NeuralNetwork"]["Architecture"]
    samples = qm9_molecules(num_samples, seed=seed, radius=arch["radius"],
                            max_neighbours=arch["max_neighbours"])
    return split_dataset(
        samples, base_config["NeuralNetwork"]["Training"]["perc_train"],
        False)


def make_objective(base_config: dict, splits, trial_epochs: int,
                   device: str = "cuda"):
    """params -> the last epoch's validation loss; inf when the trial
    fails, its reason printed ("trial failed: ...")."""
    from ..run_training import run_training

    def objective(params):
        config = json.loads(json.dumps(base_config))
        arch = config["NeuralNetwork"]["Architecture"]
        arch["model_type"] = params["model_type"]
        arch["hidden_dim"] = int(params["hidden_dim"])
        arch["num_conv_layers"] = int(params["num_conv_layers"])
        head = arch["output_heads"]["graph"]
        head["num_headlayers"] = int(params["num_headlayers"])
        head["dim_headlayers"] = [int(params["dim_headlayer"])] * int(
            params["num_headlayers"])
        if params["model_type"] == "SchNet":
            arch.setdefault("num_gaussians", 32)
            arch.setdefault("num_filters", int(params["hidden_dim"]))
        config["NeuralNetwork"]["Training"]["num_epoch"] = trial_epochs
        config["NeuralNetwork"]["Training"]["EarlyStopping"] = False
        config["Verbosity"] = {"level": 0}
        config.pop("Visualization", None)
        try:
            _, history, _, _ = run_training(config, datasets=splits,
                                            device=device)
            return float(history["val_loss"][-1])
        except Exception as e:          # a failed trial: the worst score
            print(f"trial failed: {e}")
            return float("inf")

    return objective


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="QM9 hyperparameter search (hydragnn_tpu_torch)")
    p.add_argument("--num_trials", type=int, default=10)
    p.add_argument("--num_samples", type=int, default=200)
    p.add_argument("--trial_epochs", type=int, default=4)
    p.add_argument("--log_path", default="hpo_results.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..utils.hpo import search
    base_config = load_base_config()
    splits = load_splits(args.num_samples, base_config)
    objective = make_objective(base_config, splits, args.trial_epochs,
                               device=args.device)
    best, history = search(objective, SPACE, num_trials=args.num_trials,
                           log_path=args.log_path)
    print(json.dumps({"best_params": best, "num_trials": len(history)},
                     default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
