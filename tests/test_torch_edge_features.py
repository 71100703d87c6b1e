"""PNA with edge features (`edge_features: ["lengths"]`, the eam configs)
in the port against the JAX package on the CPU: PNAConv's edge terms
(`edge_encoder`, `edge_proj`) on both layouts, forward and VJP, with the
weights carried across by `load_jax_variables`; the weights' round trip;
the bf16 forward; and the edge-length PNA lattice row through the port's
run_training and run_prediction.

Routing: with edge features the JAX package runs no Pallas kernel (the
conditions `not self.edge_dim` at hydragnn_tpu/models/convs.py:217 and
:237) but the unfused `neighbor_aggregate` (dense) and `pna_aggregate`
(edge list); the port runs its own unfused counterparts, whose edge-list
sums are the segment-sum kernel's on the card (its plain version here).

Bounds: random data rtol 1e-5, atol 1e-5 times the tensor's largest
|entry| (float32 sums in other orders); the tie-rich case (dyadic
weights, features and edge lengths, so equal messages are exactly equal
in both packages and the min/max VJPs split their gradient over the
ties) within the same bound; bf16
within 2^-5 (atol + rtol·|ref|) of the port's float32 result, JAX's
serving bound.
"""
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.convs import PNAConv as JPNAConv
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs.batch import (GraphSample, collate,
                                             neighbor_budget_for_dataset,
                                             with_neighbor_format)
from hydragnn_tpu_torch.graphs.radius import radius_graph_pbc
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models.convs import PNAConv
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.train.train_step import make_forward_fn
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.test_torch_train import _jax_view, jax_batch, numpy_tree

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

TOL = dict(rtol=1e-5)
BOUND = 2.0 ** -5
ROOT = Path(__file__).resolve().parents[1]
EAM = ROOT / "examples" / "eam" / "NiNb_EAM_energy.json"


def _random_case(seed):
    """Molecules with random features and their edge lengths."""
    mols = synthetic_molecules(6, seed=seed, min_atoms=4, max_atoms=14,
                               num_features=5, max_in_degree=7)
    samples = []
    for m in mols:
        vec = m.pos[m.senders] - m.pos[m.receivers]
        samples.append(GraphSample(
            x=m.x, pos=m.pos, senders=m.senders, receivers=m.receivers,
            edge_attr=np.linalg.norm(vec, axis=1, keepdims=True),
            y_graph=m.y_graph))
    return samples, None


def _tie_case(seed):
    """FCC NiNb-like cells: one 0/1 species feature, edge lengths 0.5 or
    0.75 by the pair's species, and dyadic weights (returned), so many
    messages of a row are exactly equal."""
    rng = np.random.RandomState(seed)
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    box = 2 * 3.52
    pos = ((grid[:, None, :] + basis[None]) / 2).reshape(-1, 3) * box
    cell = np.eye(3) * box
    samples = []
    for _ in range(2):
        z = (rng.rand(len(pos)) < 0.3).astype(np.float32)
        send, recv, shifts = radius_graph_pbc(pos, cell, 2.6)
        ea = np.where(z[send] != z[recv], 0.75, 0.5).astype(np.float32)
        samples.append(GraphSample(
            x=z[:, None], pos=pos, senders=send, receivers=recv,
            edge_attr=ea[:, None], edge_shifts=shifts, cell=cell,
            y_graph=np.zeros(1, np.float32)))
    return samples, rng


def _dyadic(tree, rng):
    return {k: (_dyadic(v, rng) if isinstance(v, dict) else
                (rng.randint(-8, 9, np.shape(v)) / 16).astype(np.float32))
            for k, v in tree.items()}


def _batches(samples):
    n = sum(s.num_nodes for s in samples) + 5
    e = sum(s.num_edges for s in samples) + 7
    edge = collate(samples, n_node=n, n_edge=e, n_graph=len(samples) + 1)
    dense = with_neighbor_format(edge, k=neighbor_budget_for_dataset(samples))
    return dense, edge


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_pnaconv_edge_features_match_jax(case, dense):
    """One PNAConv (edge_dim 1, 8 -> 6 features) on each layout: its
    output, and the VJP to the node features, the edge lengths and every
    parameter, against the JAX PNAConv from the same Flax variables."""
    samples, rng = (_random_case(3) if case == "random" else _tie_case(5))
    batch = _batches(samples)[0 if dense else 1]
    deg = tcfg.gather_deg(samples)
    n = batch.num_nodes
    fin = 8
    rs = np.random.RandomState(11)
    x = rs.randn(n, fin).astype(np.float32)
    if case == "ties":
        # the species feature, spread over fin dyadic columns
        x = np.repeat(batch.x.numpy(), fin, axis=1) * \
            (rs.randint(1, 4, fin) / 4).astype(np.float32)
    jconv = JPNAConv(out_dim=6, deg_hist=list(deg), edge_dim=1)
    jb = jax_batch(_jax_view(batch))
    variables = numpy_tree(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                      jb.pos, jb, {}))
    if rng is not None:
        variables = {"params": _dyadic(variables["params"], rng)}
    assert set(variables["params"]) == {"pre_i", "pre_j", "edge_encoder",
                                        "edge_proj", "post_nn", "lin"}
    assert set(variables["params"]["edge_proj"]) == {"kernel"}
    g = rs.randn(n, 6).astype(np.float32) * \
        batch.node_mask.numpy()[:, None]

    def jfn(params, xx, ea):
        out, _ = jconv.apply({"params": params}, xx, jb.pos,
                             jb.replace(edge_attr=ea), {})
        return out
    jout, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray,
                                                    variables["params"]),
                        jnp.asarray(x), jb.edge_attr)
    jgp, jgx, jgea = vjp(jnp.asarray(g))

    conv = PNAConv(fin, 6, deg_hist=list(deg), edge_dim=1)
    conv.load_state_dict(load_jax_variables(variables))
    tx = torch.from_numpy(x).requires_grad_(True)
    tea = batch.edge_attr.clone().requires_grad_(True)
    out, _ = conv(tx, batch.pos, batch.replace(edge_attr=tea), {})
    _close(out.detach(), jout, "out")
    params = list(conv.parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [tx, tea] + params)
    _close(grads[0], jgx, "x")
    _close(grads[1], jgea, "edge_attr")
    want = load_jax_variables({"params": numpy_tree(jgp)})
    for (name, _), got in zip(conv.named_parameters(), grads[2:]):
        _close(got, want[name], name)
    if case == "ties":
        # the case is tie-rich: most (node, feature) maxima are tied
        with torch.no_grad():
            h = (conv.pre_i(tx)[batch.receivers] + conv.pre_j(tx)[
                batch.senders] + conv.edge_proj(conv.edge_encoder(
                    batch.edge_attr))).numpy()
        recv = batch.receivers.numpy()[batch.edge_mask.numpy()]
        h = h[batch.edge_mask.numpy()]
        tied = [(h[recv == i] == h[recv == i].max(0)).sum(0) > 1
                for i in np.unique(recv)]
        assert np.mean(tied) > 0.5


def _close(got, want, what):
    """rtol 1e-5, and atol 1e-5 times the tensor's largest |entry|: a sum
    over all edges carries its rounding at the tensor's scale, not at its
    entry's (measured: 3.1e-6 of the largest entry on the tie-rich case's
    edge_encoder gradient, 9e-8 on the outputs)."""
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, err_msg=what,
                               rtol=TOL["rtol"],
                               atol=TOL["rtol"] * float(np.abs(w).max()))


def _eam_config(hidden=8, layers=2):
    with open(EAM) as fh:
        cfg = json.load(fh)
    cfg["Visualization"]["create_plots"] = False
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=hidden, num_conv_layers=layers)
    arch["output_heads"]["node"]["dim_headlayers"] = [hidden, hidden]
    return cfg


def _eam_samples(num=8, seed=0):
    """Port samples through the CFG reader's own path."""
    import tempfile

    from hydragnn_tpu_torch.datasets.cfgdataset import CFGDataset
    from hydragnn_tpu_torch.graphs.synthetic import ninb_cfg_files
    with tempfile.TemporaryDirectory() as d:
        ninb_cfg_files(d, num, seed=seed)
        return list(CFGDataset(_eam_config(), d))


@pytest.mark.parametrize("which", ["receivers", "senders", "nbr",
                                   "nbr_edge"])
def test_edge_feature_layouts_sum_as_the_plain_segment_sum(which):
    """The CSR views PNAStack.conv_args builds once a step for the edge
    features' segment sums (`kernels.segment.segment_layout`, on any
    device): summing each segment's rows in the view's order gives the
    plain segment sum of the rows, masked ones 0 (the gradients there
    are); the dense table's view by neighbour is `build_neighbor_layout`'s.
    On the CPU conv_args builds none (the plain sums need none)."""
    from hydragnn_tpu_torch.kernels.nbr import build_neighbor_layout
    from hydragnn_tpu_torch.kernels.segment import (segment_layout,
                                                    segment_sum_plain)
    from hydragnn_tpu_torch.models.stacks import PNAStack
    dense, edge = _batches(_random_case(4)[0])
    if which in ("receivers", "senders"):
        ids, keep, n = getattr(edge, which), edge.edge_mask, edge.num_nodes
    else:
        ids = getattr(dense, which).reshape(-1)
        keep = dense.nbr_mask.reshape(-1)
        n = dense.num_nodes if which == "nbr" else dense.num_edges
    row_ptr, perm = segment_layout(ids, n, keep)
    assert row_ptr.dtype == perm.dtype == torch.int32
    assert row_ptr.shape == (n + 1,) and int(row_ptr[-1]) == int(keep.sum())
    data = torch.randn(ids.shape[0], 6,
                       generator=torch.Generator().manual_seed(0))
    data = data * keep[:, None]
    got = torch.stack([data[perm[row_ptr[s]:row_ptr[s + 1]].long()].sum(0)
                       for s in range(n)])
    torch.testing.assert_close(got, segment_sum_plain(data, ids, n),
                               rtol=1e-6, atol=1e-6)
    if which == "nbr":
        ref = build_neighbor_layout(dense.nbr, dense.nbr_mask)
        assert torch.equal(row_ptr, ref[0]) and torch.equal(perm, ref[1])
    model = type("M", (), {"cfg": type("C", (), {"edge_dim": 1})})()
    for b in (dense, edge):
        assert PNAStack.conv_args(model, b).keys() == {"edge_attr"}


def test_edge_feature_weights_round_trip_with_jax():
    """A PNA stack with edge features: the Flax tree JAX initializes loads
    strictly (conv_i/edge_encoder/{kernel,bias}, conv_i/edge_proj/kernel
    included), exports back bitwise, and the model's forward matches
    JAX's on a batch of NiNb cells."""
    from hydragnn_tpu.graphs.batch import GraphSample as JSample
    samples = _eam_samples()
    cfg = _eam_config()
    tc = tcfg.update_config(copy.deepcopy(cfg), samples)
    jsamples = [JSample(x=s.x, pos=s.pos, senders=s.senders,
                        receivers=s.receivers, edge_attr=s.edge_attr,
                        edge_shifts=s.edge_shifts, y_node=s.y_node,
                        cell=s.cell) for s in samples]
    jc = jcfg.update_config(copy.deepcopy(cfg), jsamples)
    assert tc == jc
    batch = _batches(samples)[0]
    jmodel = j_create_model(jcfg.build_model_config(jc))
    variables = numpy_tree(j_init_params(jmodel, jax_batch(_jax_view(batch)),
                                         seed=3))
    conv0 = variables["params"]["conv_0"]
    assert set(conv0["edge_encoder"]) == {"kernel", "bias"}
    assert set(conv0["edge_proj"]) == {"kernel"}
    model = create_model(tcfg.build_model_config(tc), device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    back = export_jax_variables(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)
    out, _ = model(batch)
    jout, _ = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jax_batch(_jax_view(batch)), train=False)
    real = batch.node_mask.numpy()
    np.testing.assert_allclose(out[0].detach().numpy()[real],
                               np.asarray(jout[0])[real], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dense", [True, False])
def test_eam_forward_at_bf16_within_the_serving_bound(dense):
    """The eam PNA (edge lengths, 2 layers of 8) forward at bf16 on the
    CPU, the edge terms taking make_forward_fn's casts like every other
    Dense: within 2^-5 of the port's float32 result on real nodes."""
    samples = _eam_samples(seed=1)
    cfg = tcfg.update_config(_eam_config(), samples)
    mcfg = tcfg.build_model_config(cfg)
    model = create_model(mcfg, device="cpu", seed=4)
    batch = _batches(samples)[0 if dense else 1]
    with torch.no_grad():
        ref = model(batch)[0][0]
        got = make_forward_fn(model, mcfg, torch.bfloat16)(batch)[0][0]
    real = batch.node_mask
    gap = (got[real] - ref[real]).abs() - BOUND * (1 + ref[real].abs())
    assert got.dtype == torch.float32
    assert float(gap.max()) <= 0.0


def test_run_training_pna_with_edge_lengths_meets_the_lattice_row():
    """The tightened PNA row with edge lengths (RMSE and sample MAE below
    0.10, BASELINE.md:12; tests/test_graphs_sweep.py's ("PNA", lengths)
    case) through the port's run_training and run_prediction on the CPU,
    at the reference's budget: 500 deterministic BCC lattice graphs of
    the reference's cell sizes, 100 epochs."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    from tests.deterministic_data import (REFERENCE_CELL_RANGES,
                                          deterministic_samples_for_config)
    from tests.utils import make_config
    cfg = make_config("PNA", edge_features=["lengths"])
    tr = cfg["NeuralNetwork"]["Training"]
    tr["num_epoch"] = 100
    tr["EarlyStopping"] = False
    samples = [GraphSample(
        x=s.x, pos=s.pos, senders=s.senders, receivers=s.receivers,
        edge_attr=s.edge_attr, y_graph=s.y_graph)
        for s in deterministic_samples_for_config(
            cfg, num_configs=500, cell_ranges=REFERENCE_CELL_RANGES)]
    assert samples[0].edge_attr is not None
    splits = split_dataset(samples, 0.7)
    state, history, model, completed = run_training(cfg, datasets=splits,
                                                    device="cpu")
    assert completed["NeuralNetwork"]["Architecture"]["edge_dim"] == 1
    assert len(history["train_loss"]) == 100
    trues, preds = run_prediction(completed, datasets=splits, state=state,
                                  model=model, device="cpu")
    rmse = float(np.sqrt(np.mean((trues[0] - preds[0]) ** 2)))
    mae = float(np.mean(np.abs(trues[0] - preds[0])))
    assert rmse < 0.10, f"PNA (lengths) RMSE {rmse:.4f} above 0.10"
    assert mae < 0.10, f"PNA (lengths) MAE {mae:.4f} above 0.10"
