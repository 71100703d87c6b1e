"""The port's node heads and conv remat (models/layers.MLPNode
"mlp_per_node", models/base.py "conv" heads with `VecHeadConv`,
`Training.conv_checkpointing`) against the JAX package's on the CPU, with
the Flax weights carried across, on the deterministic BCC lattice at the
JAX tests' small widths (hidden 8, 2 layers, node head [4, 4]).

Bounds: forwards on real nodes within rtol / atol 2e-5; parameter
gradients (training mode, a random projection of the node output) within
1e-4 relative L2 as one vector, or within twice JAX's own float32 gap to
the port's float64 gradient where that floor is higher (SchNet's is), and
1e-3 for every tensor that carries at least 1 % of its norm
(`hold_gradients`); remat bitwise against no remat.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.models.layers import node_index_in_graph as j_node_index
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.triplets import make_triplet_transform
from hydragnn_tpu_torch.models.create import create_model, data_input_dim
from hydragnn_tpu_torch.models.layers import MLPNode, node_index_in_graph
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import (_grads_as_flax, _jax_view, jax_batch,
                                    numpy_tree, to_port_samples)
from tests.utils import make_config

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL_L2 = 1e-4
# each tensor that carries at least 1 % of the gradient's norm, relative
# L2 (a first layer's gradient runs through every layer of the stack and
# the head, SchNet's filter kernel above 1e-4)
GRAD_REL_L2_TENSOR = 1e-3
# tests/test_graphs_sweep.py::test_conv_head's sweep
CONV_HEAD_MODELS = ["SAGE", "GIN", "GAT", "MFC", "PNA", "PNAPlus", "SchNet",
                    "DimeNet", "EGNN", "PNAEq", "PAINN"]
EXTRA_ARCH = {"MACE": dict(max_ell=2, node_max_ell=1, correlation=[2])}


def lattice(num_configs=8, fixed=False):
    samples = deterministic_graph_dataset(num_configs=num_configs,
                                          heads=("node",))
    if fixed:
        # mlp_per_node needs one graph size: the modal one, as the JAX
        # package's test_models.py::test_mlp_per_node_head filters
        sizes = [s.num_nodes for s in samples]
        modal = max(set(sizes), key=sizes.count)
        samples = [s for s in samples if s.num_nodes == modal]
    return samples


def head_pair(model_type, node_arch, jsamples, dense=False, remat=False,
              seed=0):
    """(JAX model, Flax variables, JAX batch, port model config, port
    batch) for a one-node-head config of `model_type` whose head is
    `node_arch`."""
    cfg = make_config(model_type, heads=("node",),
                      **EXTRA_ARCH.get(model_type, {}))
    cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"]["type"] = \
        node_arch
    cfg["NeuralNetwork"]["Training"]["conv_checkpointing"] = remat
    samples = to_port_samples(jsamples)
    jc = jcfg.update_config(copy.deepcopy(cfg), jsamples)
    jm = jcfg.build_model_config(jc)
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    tm = data_input_dim(tcfg.build_model_config(tc), samples)
    tb = tbatch.collate(samples)
    if model_type == "DimeNet":
        tb = make_triplet_transform(samples, len(samples))(tb, samples)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
    jb = jax_batch(_jax_view(tb))
    jmodel = j_create_model(jm)
    variables = numpy_tree(j_init_params(jmodel, jb, seed=seed))
    return jmodel, variables, jb, tm, tb


def port_model(tm, variables):
    model = create_model(tm, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flax_pairs(model, grads, jgrads):
    """(name, port gradient, JAX gradient) per parameter, float64."""
    got = _grads_as_flax(model, grads)
    pairs = []
    for path, w in jax.tree_util.tree_leaves_with_path(numpy_tree(jgrads)):
        node = got
        for k in path:
            node = node[k.key]
        pairs.append(("/".join(k.key for k in path),
                      np.asarray(node, np.float64).ravel(),
                      np.asarray(w, np.float64).ravel()))
    assert len(pairs) == len(list(model.parameters()))
    return pairs


def whole_gap(model, grads, jgrads) -> float:
    """The gradient's relative L2 gap to JAX's, as one vector."""
    pairs = flax_pairs(model, grads, jgrads)
    return float(np.linalg.norm(np.concatenate([g - w for _, g, w in pairs]))
                 / np.linalg.norm(np.concatenate([w for _, _, w in pairs])))


def hold_gradients(model, grads, jgrads, bound=GRAD_REL_L2):
    """The parameter gradients against JAX's: as one vector within
    `bound` relative L2, each tensor's L2 gap within `bound` of the whole
    vector's norm, and within GRAD_REL_L2_TENSOR of its own
    where its norm is at least 1 % of the whole's (below that a tensor
    can be cancellation noise: a bias before a training-mode batch norm
    has an exact gradient of 0). Returns the whole vector's gap."""
    pairs = flax_pairs(model, grads, jgrads)
    whole = np.linalg.norm(np.concatenate([w for _, _, w in pairs]))
    assert whole > 0
    for name, g, w in pairs:
        gap = np.linalg.norm(g - w)
        assert gap <= bound * whole, (name, gap / whole)
        if np.linalg.norm(w) >= 1e-2 * whole:
            assert gap <= GRAD_REL_L2_TENSOR * np.linalg.norm(w), (
                name, gap / np.linalg.norm(w))
    total = np.linalg.norm(np.concatenate([g - w for _, g, w in pairs]))
    assert total <= bound * whole, total / whole
    return total / whole


def train_grads(model, tb, c):
    model.train()
    (out,), _ = model(tb)
    loss = torch.sum(out * c)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    return out.detach(), grads


def hold_head(model_type, node_arch, jsamples, dense):
    """The eval forward on real nodes, then training mode's parameter
    gradients of a random projection of the node output, each against
    the JAX package's on the same Flax variables."""
    jmodel, variables, jb, tm, tb = head_pair(model_type, node_arch,
                                              jsamples, dense)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want, _ = jmodel.apply(jvars, jb, train=False)
    model = port_model(tm, variables)
    real = tb.node_mask.numpy()
    with torch.no_grad():
        (got,), _ = model(tb)
    assert got.shape == tuple(np.shape(want[0]))
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want[0])[real],
                               **FWD_TOL)
    c = np.random.RandomState(1).randn(*np.shape(want[0])).astype(np.float32)
    c[~real] = 0.0

    def jloss(params):
        (out, _), _ = jmodel.apply(
            {"params": params, "batch_stats": jvars.get("batch_stats", {})},
            jb, train=True, mutable=["batch_stats"])
        return jnp.sum(out[0] * c)
    jgrads = jax.grad(jloss)(jvars["params"])
    grads = train_grads(model, tb, torch.from_numpy(c))[1]
    gap = whole_gap(model, grads, jgrads)
    if gap > GRAD_REL_L2:
        # JAX's own float32 rounding: its gradient's gap to the port's
        # float64 one (same weights, same batch)
        model64 = port_model(tm, variables).double()
        tb64 = tb.replace(x=tb.x.double(), pos=tb.pos.double())
        g64 = train_grads(model64, tb64, torch.from_numpy(c).double())[1]
        floor = whole_gap(model64, g64, jgrads)
        assert gap <= 2 * floor, (gap, floor)
    return hold_gradients(model, grads, jgrads, max(gap, GRAD_REL_L2))


@pytest.mark.parametrize("model_type", CONV_HEAD_MODELS)
def test_conv_head_matches_jax(model_type):
    """A "conv" node head (fresh convs conv_{L + 100 ih + li}, each with
    its masked batch norm and activation, then the Dense head_0_out; the
    vector-channel stacks through `VecHeadConv` from the encoder's final
    channel) on the edge list."""
    hold_head(model_type, "conv", lattice(), dense=False)


@pytest.mark.parametrize("model_type", ["GIN", "PNA", "SchNet", "PAINN"])
def test_conv_head_matches_jax_on_the_dense_layout(model_type):
    """The same heads on the dense neighbour layout, whose conv_args
    layouts the head convs share with the encoder."""
    hold_head(model_type, "conv", lattice(), dense=True)


@pytest.mark.parametrize("model_type", ["GIN", "PNA", "MACE"])
def test_mlp_per_node_head_matches_jax(model_type):
    """An "mlp_per_node" head (BaseStack's decoder; MACE's readouts) on
    graphs of one size: weights banked by node index within the graph."""
    hold_head(model_type, "mlp_per_node", lattice(16, fixed=True),
              dense=False)


def test_node_index_in_graph_bitwise_and_clipped():
    """node_index_in_graph equals the JAX package's on a padded batch, and
    the head clips it to the bank (padding nodes sit past it)."""
    samples = to_port_samples(lattice(6))
    tb = tbatch.collate(samples)
    got = node_index_in_graph(tb.node_graph, tb.num_graphs)
    want = np.asarray(j_node_index(jnp.asarray(tb.node_graph.numpy()),
                                   tb.num_graphs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    head = MLPNode(3, [4], 2, node_type="mlp_per_node", num_nodes=2)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape))
    x = torch.randn(5, 3)
    idx = torch.tensor([0, 1, 7, 2, 1], dtype=torch.int32)
    out = head(x, idx)
    h = torch.relu(torch.einsum("ni,nif->nf", x, head.w_0[[0, 1, 1, 1, 1]])
                   + head.b_0[[0, 1, 1, 1, 1]])
    ref = (torch.einsum("ni,nif->nf", h, head.w_1[[0, 1, 1, 1, 1]])
           + head.b_1[[0, 1, 1, 1, 1]])
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="node_index_in_graph"):
        head(x)


def test_mlp_per_node_refused_for_graphs_of_varying_size():
    """Config completion refuses mlp_per_node when the graphs' sizes vary,
    with the JAX package's message."""
    jsamples = lattice(8)
    assert len({s.num_nodes for s in jsamples}) > 1
    cfg = make_config("GIN", heads=("node",))
    cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"]["type"] = \
        "mlp_per_node"
    with pytest.raises(ValueError, match="variable graph size") as jerr:
        jcfg.update_config(copy.deepcopy(cfg), jsamples)
    with pytest.raises(ValueError, match="variable graph size") as terr:
        tcfg.update_config(copy.deepcopy(cfg), to_port_samples(jsamples))
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------- remat --

@pytest.mark.parametrize("model_type,node_arch", [
    ("GIN", "mlp"), ("PNA", "mlp"), ("SchNet", "conv"), ("EGNN", "mlp"),
    ("PAINN", "conv")])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edge"])
def test_conv_checkpointing_is_bitwise_no_remat(model_type, node_arch,
                                                dense):
    """Training.conv_checkpointing recomputes each encoder conv in the
    backward: the same parameters, outputs, gradients and running
    statistics as without it, bit for bit (counterpart:
    tests/test_training.py::test_conv_checkpointing_equivalent, there
    within rtol 1e-5)."""
    jsamples = lattice()
    _, variables, _, tm, tb = head_pair(model_type, node_arch, jsamples,
                                        dense)
    tm_remat = dataclasses.replace(tm, conv_checkpointing=True)
    plain, remat = port_model(tm, variables), port_model(tm_remat, variables)
    assert list(plain.state_dict()) == list(remat.state_dict())
    c = torch.from_numpy(np.random.RandomState(2).randn(
        tb.num_nodes, 1).astype(np.float32))
    out0, g0 = train_grads(plain, tb, c)
    out1, g1 = train_grads(remat, tb, c)
    assert torch.equal(out0, out1)
    assert any(float(g.abs().max()) > 0 for g in g0)
    for (name, _), a, b in zip(plain.named_parameters(), g0, g1):
        assert torch.equal(a, b), name
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), name


def test_conv_checkpointing_trains_bitwise_through_run_training(tmp_path,
                                                                 monkeypatch):
    """run_training takes Training.conv_checkpointing (no longer refused)
    and its history and final parameters equal the run without it."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    monkeypatch.chdir(tmp_path)
    splits = split_dataset(to_port_samples(
        deterministic_graph_dataset(num_configs=20)), 0.7)
    runs = []
    for remat in (False, True):
        cfg = make_config("PNA")
        tr = cfg["NeuralNetwork"]["Training"]
        tr.update(num_epoch=2, EarlyStopping=False, batch_size=8,
                  conv_checkpointing=remat)
        state, history, _, _ = run_training(cfg, datasets=splits,
                                            device="cpu")
        runs.append((state, history))
    (s0, h0), (s1, h1) = runs
    for key in ("train_loss", "val_loss", "test_loss"):
        assert h0[key] == h1[key], key
    for (name, a), b in zip(s0.params.items(), s1.params.values()):
        assert torch.equal(a, b), name
