"""Shared fixtures of the pipeline tests (tests/test_torch_pipeline*.py):
the same microbatches and the same weights in the JAX package and the
port, at a small size (4 layers, hidden 8, 2 stages, 4 microbatches of 4
graphs), the stages all on the CPU."""
import copy

import jax
import numpy as np

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.datasets.loader import _stack_batches
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu.parallel.mesh import make_mesh
from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu.train.train_step import TrainState as JState
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import stack_batches
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from hydragnn_tpu_torch.train.optimizer import select_optimizer
from hydragnn_tpu_torch.train.train_step import TrainState
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (jax_batch, numpy_tree, to_jax_samples,
                                    to_port_samples)
from tests.utils import make_config

S = 2            # stages
M = 4            # microbatches
LAYERS = 4
CPU = ["cpu"] * S
STEPS = 3        # steps each package takes in the step tests
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
# PNA's std near a zero variance (the fixture's one-feature rows) scales
# float32 rounding by up to 1 / (2 sqrt(1e-5)), and SchNet's filter sums
# round in another order than XLA's: the port's standing stack bounds
# against JAX (tests/test_torch_pna.py, tests/test_torch_schnet.py)
STACK_TOL = dict(rtol=1e-4, atol=1e-5)


def tol_for(model_type):
    return STACK_TOL if model_type in ("PNA", "SchNet") else PARAM_TOL


def molecules(n=16, seed=6):
    """Five-feature molecules (tests/test_torch_train.py's PNA data): no
    zero-variance neighbourhoods, where PNA's std amplifies rounding."""
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    return synthetic_molecules(n, seed=seed, min_atoms=4, max_atoms=14,
                               num_features=5, max_in_degree=6)


def lj_samples(n, seed=0):
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    return lj_configurations(n, seed=seed)


def ef_config(layers=LAYERS):
    """Equivariant SchNet, a node energy head, compute_grad_energy (the
    JAX package's pipelined EF fixture)."""
    cfg = make_config("SchNet", heads=("node",), equivariance=True,
                      num_conv_layers=layers)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch["radius"] = 2.0
    arch["max_neighbours"] = 64
    voi = cfg["NeuralNetwork"]["Variables_of_interest"]
    voi.update(type=["node"], output_names=["node_energy"], output_index=[0],
               output_dim=[1])
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(compute_grad_energy=True, task_weights=[1.0])
    return cfg


class Fixture:
    """One model in both packages on the same stacked microbatches."""

    def __init__(self, model_type="GIN", dense=True, heads=("graph",),
                 ef=False, layers=LAYERS, n_graphs=16, micro=M,
                 samples=None, seed=0, n_node=None, n_edge=None):
        if ef:
            cfg = ef_config(layers)
            samples = samples or lj_samples(n_graphs, seed)
        else:
            cfg = make_config(model_type, heads=heads,
                              num_conv_layers=layers)
            samples = samples or to_port_samples(
                deterministic_graph_dataset(num_configs=n_graphs,
                                            heads=heads))
            cfg["NeuralNetwork"]["Variables_of_interest"][
                "input_node_features"] = list(range(samples[0].x.shape[1]))
        self.samples = samples
        jsamples = to_jax_samples(samples)
        jc = jcfg.update_config(copy.deepcopy(cfg), jsamples)
        tc = tcfg.update_config(copy.deepcopy(cfg), samples)
        self.cfg = cfg
        self.jmcfg = jcfg.build_model_config(jc)
        self.mcfg = tcfg.build_model_config(tc)
        per = n_graphs // micro
        n_node = n_node or 64 * (-(-(max(s.num_nodes for s in samples)
                                     * per + 1) // 64))
        n_edge = n_edge or 64 * (-(-(max(s.num_edges for s in samples)
                                     * per + 1) // 64))
        k = tbatch.neighbor_budget_for_dataset(samples) if dense else None
        jmicro, tmicro = [], []
        for i in range(0, n_graphs, per):
            jb = jbatch.collate(jsamples[i:i + per], n_node=n_node,
                                n_edge=n_edge, n_graph=per + 1, np_out=True)
            tb = tbatch.collate(samples[i:i + per], n_node=n_node,
                                n_edge=n_edge, n_graph=per + 1)
            if dense:
                jb = jbatch.with_neighbor_format(jb, k=k)
                tb = tbatch.with_neighbor_format(tb, k=k)
            jmicro.append(jb)
            tmicro.append(tb)
        self.jstacked = jax_batch(_stack_batches(jmicro))
        self.stacked = stack_batches(tmicro)
        self.params = numpy_tree(jpt.init_pipeline_params(
            jax.random.PRNGKey(seed), self.jmcfg, jax_batch(jmicro[0])))
        self.mesh = make_mesh((("pipe", S),), devices=jax.devices()[:S])

    def model(self, devices=CPU):
        model = tpt.PipelineModel(self.mcfg, devices)
        model.load_state_dict(load_jax_variables({"params": self.params}))
        return model.place()

    def states(self, optimizer=None, devices=CPU):
        """(port model, port state, port tx, JAX state, JAX tx) from the
        same weights; SGD at lr 0.01 by default."""
        train = {"Optimizer": optimizer or {"type": "SGD",
                                            "learning_rate": 0.01}}
        jtx = jopt.select_optimizer(copy.deepcopy(train))
        tx = select_optimizer(copy.deepcopy(train))
        model = self.model(devices)
        jstate = JState.create({"params": jax.tree_util.tree_map(
            np.array, self.params)}, jtx)
        return model, TrainState.create(model, tx), tx, jstate, jtx


def port_tree(model):
    """The port's parameters as the JAX package's pipelined tree."""
    from hydragnn_tpu_torch.utils.weights import export_jax_variables
    return export_jax_variables(model)["params"]


def assert_trees(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees(got[k], want[k], tol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **tol)


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(x))
                           for x in jax.tree_util.tree_leaves(tree)])


def metrics_close(got, want, tol):
    """A step's metrics against JAX's: the same keys, each within `tol`,
    `nonfinite_steps` exactly 0 in both."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if k == "nonfinite_steps":
            assert float(got[k]) == float(want[k]) == 0.0
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=k, **tol)
