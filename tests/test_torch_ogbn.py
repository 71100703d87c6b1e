"""The port's sampled-training driver (hydragnn_tpu_torch.examples.ogbn)
against the JAX package's (examples/ogbn/train_ogbn.py) on the CPU, at a
small synthetic graph:

* plan_fp equals JAX's driver's, and (synchronous sampling) the fetch
  accounting in result.json equals what JAX's loader counts over the
  same iteration;
* the first step's loss from JAX's driver's initial weights within rtol
  1e-5 of the JAX driver's own first step, exact and historical;
* two port runs give bitwise equal histories and parameter digests;
* a run stopped after epoch 1 and resumed (`--resume`) ends bitwise the
  uninterrupted run;
* the driver runs on the card unless `--device cpu`: the default raises
  here, before any work.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.ogbn import ogbn_data as jdata
from examples.ogbn import train_ogbn as jdriver
from hydragnn_tpu.models import init_params as j_init_params
from hydragnn_tpu.preprocess import sampling as jsamp
from hydragnn_tpu.train import train_step as jstep
from hydragnn_tpu_torch.examples import ogbn
from tests.test_torch_train import numpy_tree

torch.set_num_threads(1)

ARGS = ["--num-nodes", "400", "--batch-size", "32", "--num-epochs", "2"]
FIRST_RTOL = 1e-5


def _args(tmp, *extra):
    return ogbn.parse_args(ARGS + ["--job-dir", str(tmp), "--device", "cpu",
                                   *extra])


def _jax_first_step(args, staleness_k):
    """(plan_fp, the initial variables, the first step's metrics, the
    fetch stats after the driver's iteration) of JAX's driver, built from
    its own functions with the same arguments."""
    config = ogbn.load_ogbn_config(args.inputfile, args.num_epochs,
                                   args.batch_size)
    train_cfg = config["NeuralNetwork"]["Training"]
    fanouts = tuple(train_cfg["Sampling"]["fanouts"])
    data = jdata.load_ogbn(None, num_nodes=args.num_nodes,
                           seed=args.data_seed)
    B = int(train_cfg["batch_size"])
    common = dict(senders=data.senders, receivers=data.receivers,
                  batch_size=B, fanouts=fanouts, seed=args.seed,
                  num_partitions=train_cfg["Sampling"]["partitions"],
                  partition_mode="range", num_layers=2, async_workers=0)
    loader = jsamp.NeighborSamplingLoader(
        x=data.x, y_node=data.y_onehot, train_nodes=data.train_idx,
        staleness_k=staleness_k, **common)
    mcfg, model, tx, step, _ = jdriver.build_model_and_steps(
        copy.deepcopy(config), data, fanouts, staleness_k)
    loader.set_epoch(0)
    first = next(iter(loader))
    init = first
    if staleness_k:
        init = first.replace(hist_states=jnp.zeros(
            (1, first.x.shape[0], mcfg.hidden_dim)))
    variables = numpy_tree(j_init_params(model, init, seed=args.seed))
    state = jstep.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    if staleness_k:
        tables = jsamp.init_hist_tables(data.x, mcfg.hidden_dim, 2)
        _, _, m = step(state, first, tables, jnp.asarray(True))
    else:
        _, m = step(state, first)
    for epoch in range(int(train_cfg["num_epoch"])):
        loader.set_epoch(epoch)
        for _ in loader:
            pass
    return (loader.plan_fingerprint(), variables,
            {k: float(v) for k, v in m.items()}, loader.fetch_stats())


@pytest.mark.parametrize("staleness_k", [0, 2])
def test_driver_plan_and_first_step_match_jax(tmp_path, staleness_k):
    args = _args(tmp_path, "--staleness-k", str(staleness_k),
                 "--async-workers", "0")
    plan_fp, variables, jm, jfetch = _jax_first_step(args, staleness_k)
    result, info = ogbn.run(args, variables=variables)
    assert result["plan_fp"] == plan_fp
    assert result["fetch_stats"] == jfetch
    assert sorted(info.first_metrics) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(info.first_metrics[k], v,
                                   rtol=FIRST_RTOL, err_msg=k)
    with open(tmp_path / "result.json") as f:
        written = json.load(f)
    assert written["history"] == result["history"]
    assert written["staleness_k"] == staleness_k
    assert len(result["history"]["val_acc"]) == 2
    assert info.train_captures == 0          # no CUDA graph on the CPU


def test_driver_twice_bitwise_and_resume_bitwise(tmp_path):
    """Two uninterrupted runs (background sampling, the default) agree
    bit for bit; a run stopped after epoch 1 and resumed with --resume
    ends with the same history and parameter digest."""
    runs = []
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        runs.append(ogbn.run(_args(tmp_path / name))[0])
    a, b = runs
    assert a["history"] == b["history"]
    assert a["param_digest"] == b["param_digest"]
    assert a["plan_fp"] == b["plan_fp"]
    (tmp_path / "c").mkdir()
    ogbn.run(ogbn.parse_args(ARGS[:-1] + ["1", "--job-dir",
                                          str(tmp_path / "c"), "--device",
                                          "cpu"]))
    resumed, _ = ogbn.run(_args(tmp_path / "c", "--resume"))
    assert resumed["history"] == a["history"]
    assert resumed["param_digest"] == a["param_digest"]
    assert resumed["step"] == a["step"] == resumed["final_step"]


def test_driver_defaults_to_the_card(tmp_path):
    args = ogbn.parse_args(["--job-dir", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ogbn.run(args)
    assert not (tmp_path / "result.json").exists()
    assert not (tmp_path / "logs").exists()
