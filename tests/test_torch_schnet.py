"""The port's SchNet (hydragnn_tpu_torch/models/schnet.py) and its ops
against the JAX package's, on the CPU, with the Flax weights carried
across by utils/weights.load_jax_variables, on the Lennard-Jones data
(examples/LennardJones/LJ.json at its published widths).

Bounds:
* `edge_vectors`, `shifted_softplus`: the same float32 arithmetic up to
  the order of a 3-term sum and the log1p/exp of logaddexp, rtol 1e-6 /
  atol 1e-7.
* `gaussian_basis`: `torch.linspace` and `jnp.linspace` place the centres
  up to 1.2e-7 apart on [0, 2] (a few of 32 differ in the last bit), and
  gamma derives from the first spacing; on distances in [0, 2.5] the
  bases agree within atol 2e-6 (measured 1.2e-6).
* one CFConv and the whole stack: rtol 1e-4 / atol 1e-5 on real nodes,
  as for PNA (tests/test_torch_pna.py): GEMM and segment sums add in
  other orders, amplified by two BatchNorm'd layers (measured at LJ
  width: 6.9e-8 abs, 3.1e-6 relative, on outputs up to 0.03).
"""
import copy
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models import schnet as jschnet
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.ops.basis import gaussian_basis as j_gaussian_basis
from hydragnn_tpu.ops import segment as jseg
from hydragnn_tpu.ops.geometry import edge_vectors as j_edge_vectors
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
from hydragnn_tpu_torch.models import schnet as tschnet
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.ops.basis import gaussian_basis
from hydragnn_tpu_torch.ops import segment as tseg
from hydragnn_tpu_torch.ops.geometry import edge_vectors
from hydragnn_tpu_torch.utils.weights import load_jax_variables

sys.path.insert(0, ".")
from examples.LennardJones.lj_data import generate_lj_dataset  # noqa: E402

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
LJ = "examples/LennardJones/LJ.json"


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def with_random_batch_stats(variables, seed):
    """Nontrivial running statistics, so eval-mode BatchNorm is tested."""
    rng = np.random.RandomState(seed)
    tree = numpy_tree(variables)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                node[k] = rng.randn(*v.shape).astype(np.float32) * 0.3
            else:
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    stats = jax.tree_util.tree_map(np.array, tree["batch_stats"])
    fill(stats)
    return {"params": tree["params"], "batch_stats": stats}


def lj_batches(num, dense):
    tb = tbatch.collate(lj_configurations(num, seed=4))
    jb = jbatch.collate(generate_lj_dataset(num, seed=4), np_out=True)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
        jb = jbatch.with_neighbor_format(jb)
    return tb, jax.tree_util.tree_map(jnp.asarray, jb)


def test_edge_vectors_basis_and_softplus_match_jax():
    tb, jb = lj_batches(3, dense=False)
    vec, length = edge_vectors(tb.pos, tb.senders, tb.receivers,
                               tb.edge_shifts)
    jvec, jlength = j_edge_vectors(jb.pos, jb.senders, jb.receivers,
                                   jb.edge_shifts)
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(length.numpy(), np.asarray(jlength),
                               rtol=1e-6, atol=1e-7)
    # padding edges: self-loops on the padding node, length sqrt(eps)
    pad = ~tb.edge_mask.numpy()
    assert pad.any()
    np.testing.assert_allclose(length.numpy()[pad], 1e-9 ** 0.5, rtol=1e-6)

    d = np.linspace(0.0, 2.5, 4001).astype(np.float32)
    got = gaussian_basis(torch.from_numpy(d), 0.0, 2.0, 32).numpy()
    want = np.asarray(j_gaussian_basis(jnp.asarray(d), 0.0, 2.0, 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [-1e4, 1e4, 0.0]]).astype(np.float32)
    got = tschnet.shifted_softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jschnet.shifted_softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all() and got[-2] == np.float32(1e4) - \
        np.float32(np.log(2.0))


@pytest.mark.parametrize("dense", [False, True])
def test_edge_aggregates_match_jax(dense):
    """edge_aggregate_sum/mean and filter_weighted_aggregate on both
    layouts (the masked K reduction, the segment sum / filter-scatter)
    against the JAX package's; the sums add in other orders (SUM 2e-5)."""
    tb, jb = lj_batches(2, dense)
    rng = np.random.RandomState(1)
    vals = rng.randn(tb.num_edges, 3).astype(np.float32)
    h = rng.randn(tb.num_nodes, 6).astype(np.float32)
    w = rng.randn(tb.num_edges, 6).astype(np.float32)
    real = tb.node_mask.numpy()
    pairs = [
        (tseg.edge_aggregate_sum(torch.from_numpy(vals), tb),
         jseg.edge_aggregate_sum(jnp.asarray(vals), jb)),
        (tseg.edge_aggregate_mean(torch.from_numpy(vals), tb),
         jseg.edge_aggregate_mean(jnp.asarray(vals), jb)),
        (tseg.filter_weighted_aggregate(torch.from_numpy(h),
                                        torch.from_numpy(w), tb),
         jseg.filter_weighted_aggregate(jnp.asarray(h), jnp.asarray(w), jb)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dense", [False, True])
def test_cfconv_matches_jax(dense):
    tb, jb = lj_batches(2, dense)
    rng = np.random.RandomState(0)
    x = rng.randn(tb.num_nodes, 5).astype(np.float32)
    _, length = edge_vectors(tb.pos, tb.senders, tb.receivers,
                             tb.edge_shifts)
    _, jlength = j_edge_vectors(jb.pos, jb.senders, jb.receivers,
                                jb.edge_shifts)
    conv = jschnet.CFConv(out_dim=7, num_filters=12, num_gaussians=10,
                          cutoff=2.0, equivariant=True)
    jargs = (jnp.asarray(x), jb.pos, jb, {"edge_length": jlength})
    variables = conv.init(jax.random.PRNGKey(2), *jargs)
    want_h, want_pos = conv.apply(variables, *jargs)
    port = tschnet.CFConv(5, 7, num_filters=12, num_gaussians=10,
                          cutoff=2.0, equivariant=True)
    port.load_state_dict(load_jax_variables(numpy_tree(variables)))
    with torch.no_grad():
        got_h, got_pos = port(torch.from_numpy(x), tb.pos, tb,
                              {"edge_length": length})
    real = tb.node_mask.numpy()
    np.testing.assert_allclose(got_h.numpy()[real],
                               np.asarray(want_h)[real], **TOL)
    np.testing.assert_allclose(got_pos.numpy()[real],
                               np.asarray(want_pos)[real], **TOL)
    assert not np.array_equal(got_pos.numpy(), tb.pos.numpy())


@pytest.fixture(scope="module")
def lj_model():
    """LJ.json at its published widths (SchNet 32/32/32, radius 2, 2
    equivariant layers, node head [32, 32] -> 1) over 4 configurations."""
    with open(LJ) as f:
        base = json.load(f)
    tc = tcfg.update_config(copy.deepcopy(base), lj_configurations(4, seed=4))
    jc = jcfg.update_config(copy.deepcopy(base),
                            generate_lj_dataset(4, seed=4))
    jmodel = j_create_model(jcfg.build_model_config(jc))
    mcfg = tcfg.build_model_config(tc)
    _, jb = lj_batches(4, dense=False)
    variables = with_random_batch_stats(j_init_params(jmodel, jb, seed=3), 5)
    return jmodel, mcfg, variables


@pytest.mark.parametrize("dense", [False, True])
def test_scf_stack_at_lj_width_matches_jax(lj_model, dense):
    jmodel, mcfg, variables = lj_model
    assert (mcfg.model_type, mcfg.hidden_dim, mcfg.num_filters,
            mcfg.num_gaussians, mcfg.num_conv_layers) == ("SchNet", 32, 32,
                                                          32, 2)
    assert mcfg.equivariance and mcfg.heads[0].head_type == "node"
    tb, jb = lj_batches(4, dense)
    want, _ = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jb, train=False)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    with torch.no_grad():
        got, var = model(tb)
    assert var is None and len(got) == 1
    real = tb.node_mask.numpy()
    g, w = got[0].numpy()[real], np.asarray(want[0])[real]
    assert g.shape == (4 * 27, 1) and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, **TOL)


def test_schnet_weights_map_mechanically_and_strictly(lj_model):
    """Every Flax leaf of the LJ SchNet lands on one port tensor (strict
    load_state_dict): filter_nn.dense_{j}, lin1 without a bias, lin2,
    lin_out, coord_mlp.dense_{j}, and a BatchNorm after every conv."""
    _, mcfg, variables = lj_model
    state = load_jax_variables(variables)
    model = create_model(mcfg, device="cpu")
    assert set(state) == set(model.state_dict())
    for i in range(2):
        assert f"conv_{i}.lin1.weight" in state
        assert f"conv_{i}.lin1.bias" not in state
        assert f"conv_{i}.coord_mlp.dense_1.weight" in state
        assert f"feature_norm_{i}.mean" in state
    model.load_state_dict(state)
    w = variables["params"]["conv_1"]["filter_nn"]["dense_0"]["kernel"]
    assert torch.equal(model.conv_1.filter_nn.dense_0.weight,
                       torch.from_numpy(np.array(w).T))


def test_create_model_schnet_requires_radius(lj_model):
    import dataclasses
    _, mcfg, _ = lj_model
    with pytest.raises(ValueError, match="radius"):
        create_model(dataclasses.replace(mcfg, radius=None), device="cpu")
    model = create_model(mcfg, device="cpu")
    assert isinstance(model, tschnet.SCFStack) and not model.training


def test_ef_segment_sums_reuse_the_filter_layouts(lj_model, monkeypatch):
    """The EF path's segment sums over edges (the position gathers'
    backward in `edge_vectors`, the coordinate update's mean) take the
    forward's two filter layouts instead of sorting: with the layouts
    built on the CPU too (the card builds them; the CPU's plain versions
    ignore them), every such sum receives the receiver- or sender-sorted
    (row_ptr, order) of `conv_args`' layouts, energies and forces stay
    bitwise those of the plain path, and within TOL of the JAX package's
    energy_forces_from_node_head."""
    from hydragnn_tpu.train.loss import energy_forces_from_node_head as j_ef
    from hydragnn_tpu_torch.kernels import fused_mp
    from hydragnn_tpu_torch.kernels import segment as kseg
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    jmodel, mcfg, variables = lj_model
    tb, jb = lj_batches(4, dense=False)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    want_e, want_f = energy_forces_from_node_head(model, tb)

    built, seen = [], []

    def layouts_on_any_device(s, r, m, n):
        built.append((fused_mp.csr_layout(s, r, m, n),
                      fused_mp.csr_layout(r, s, m, n)))
        return built[-1]

    plain_sum = kseg.segment_sum

    def spy(data, ids, n, indices_are_sorted=False, layout=None):
        seen.append((ids, layout))
        return plain_sum(data, ids, n, indices_are_sorted, layout)
    monkeypatch.setattr(tschnet, "filter_layouts", layouts_on_any_device)
    monkeypatch.setattr(kseg, "segment_sum", spy)
    got_e, got_f = energy_forces_from_node_head(model, tb)
    assert torch.equal(got_e, want_e) and torch.equal(got_f, want_f)

    assert len(built) == 1
    by_recv, by_send = fused_mp.segment_layouts(built[0])
    edge_sums = [(ids, lay) for ids, lay in seen
                 if ids.shape[0] == tb.num_edges]
    # 2 gathers' backward in conv_args + 2 layers' coordinate means
    assert len(edge_sums) == 4
    for ids, lay in edge_sums:
        want = by_send if ids is tb.senders else by_recv
        assert lay is not None and lay[0] is want[0] and lay[1] is want[1]
    assert sum(ids is tb.senders for ids, _ in edge_sums) == 1

    def apply_fn(v, b, train=False):
        return jmodel.apply(v, b, train=False), None
    je, jf, _ = j_ef(apply_fn, jax.tree_util.tree_map(jnp.asarray, variables),
                     jb)
    real = tb.node_mask.numpy()
    graphs = tb.graph_mask.numpy()
    np.testing.assert_allclose(got_e.numpy()[graphs], np.asarray(je)[graphs],
                               **TOL)
    np.testing.assert_allclose(got_f.numpy()[real], np.asarray(jf)[real],
                               **TOL)
    assert np.abs(got_f.numpy()[real]).max() > 0
