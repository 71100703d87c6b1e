"""The port's PNA forward against the JAX package's, on the CPU, with the
Flax weights carried across by utils/weights.load_jax_variables.

Bound: rtol 1e-4, atol 1e-5 on real rows and graphs only (padding rows
are garbage-but-finite by design: the attenuation scaler divides by
log(1) on zero-degree padding nodes). The two packages agree in every
gather, mask and count; they differ in the order of the float32 sums
inside matmuls (XLA's vs PyTorch's CPU GEMM) and segment reductions,
which six BatchNorm'd layers amplify to a few 1e-6 relative at most.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs import batch as jbatch
from hydragnn_tpu.models import convs as jconvs
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.graphs import batch as tbatch
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models import convs as tconvs
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.utils.weights import load_jax_variables

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
CSCE = "examples/csce/csce_gap.json"


def to_jax_samples(samples):
    return [jbatch.GraphSample(x=s.x, pos=s.pos, senders=s.senders,
                               receivers=s.receivers, y_graph=s.y_graph)
            for s in samples]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def randomize_batch_stats(variables, seed):
    """Nontrivial running statistics, so eval-mode BatchNorm is tested."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a), dict(variables.get("batch_stats", {})))

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                tree[k] = rng.randn(*v.shape).astype(np.float32) * 0.3
            else:
                tree[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    stats = {k: dict(v) if isinstance(v, dict) else v
             for k, v in stats.items()}
    for v in stats.values():
        fill(v)
    return {"params": numpy_tree(variables["params"]), "batch_stats": stats}


def batches(samples, dense):
    tb = tbatch.collate(samples)
    jb = jbatch.collate(to_jax_samples(samples), np_out=True)
    if dense:
        tb = tbatch.with_neighbor_format(tb)
        jb = jbatch.with_neighbor_format(jb)
    return tb, jax.tree_util.tree_map(jnp.asarray, jb)


@pytest.mark.parametrize("dense", [True, False])
def test_pna_conv_matches_jax(dense):
    samples = synthetic_molecules(5, seed=11, min_atoms=4, max_atoms=14,
                                  num_features=6, max_in_degree=6)
    tb, jb = batches(samples, dense)
    deg = tcfg.gather_deg(samples)
    rng = np.random.RandomState(0)
    x = rng.randn(tb.num_nodes, 6).astype(np.float32)
    conv = jconvs.PNAConv(out_dim=10, deg_hist=tuple(deg))
    variables = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jb.pos, jb,
                          {})
    want, _ = conv.apply(variables, jnp.asarray(x), jb.pos, jb, {})
    port = tconvs.PNAConv(6, 10, deg_hist=tuple(deg))
    port.load_state_dict(load_jax_variables(numpy_tree(variables)))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), tb.pos, tb, {})
    real = tb.node_mask.numpy()
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               **TOL)


@pytest.fixture(scope="module")
def csce_model():
    """The csce PNA config at its published width (200 hidden, 6 layers,
    graph head 200 -> [200, 200]) over 4 small molecules."""
    samples = synthetic_molecules(4, seed=21, min_atoms=6, max_atoms=16)
    with open(CSCE) as f:
        base = json.load(f)
    tc = tcfg.update_config(copy.deepcopy(base), samples)
    jc = jcfg.update_config(copy.deepcopy(base), to_jax_samples(samples))
    jmodel = j_create_model(jcfg.build_model_config(jc))
    mcfg = tcfg.build_model_config(tc)
    return samples, jmodel, mcfg


@pytest.mark.parametrize("dense", [True, False])
def test_pna_stack_at_csce_width_matches_jax(csce_model, dense):
    samples, jmodel, mcfg = csce_model
    assert (mcfg.hidden_dim, mcfg.num_conv_layers) == (200, 6)
    tb, jb = batches(samples, dense)
    variables = randomize_batch_stats(j_init_params(jmodel, jb, seed=3), 5)
    want, _ = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jb, train=False)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    with torch.no_grad():
        got, var = model(tb)
    assert var is None and len(got) == 1
    gm = tb.graph_mask.numpy()
    g, w = got[0].numpy()[gm], np.asarray(want[0])[gm]
    assert g.shape == (4, 1)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, **TOL)


def test_load_jax_variables_rejects_unknown_and_missing_keys(csce_model):
    samples, jmodel, mcfg = csce_model
    _, jb = batches(samples, False)
    variables = numpy_tree(j_init_params(jmodel, jb))
    model = create_model(mcfg, device="cpu")
    bad = copy.deepcopy(variables)
    bad["params"]["conv_0"]["pre_i"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        load_jax_variables(bad)
    missing = copy.deepcopy(variables)
    del missing["params"]["head_0"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(load_jax_variables(missing))
    with pytest.raises(KeyError):
        load_jax_variables({"params": {}, "cache": {}})


def test_create_model_other_types_and_training_mode_raise(csce_model):
    import dataclasses
    _, _, mcfg = csce_model
    # a conv-type node head builds its convs under the JAX package's
    # names (tests/test_torch_node_heads.py holds them against JAX)
    conv_head = dataclasses.replace(mcfg.heads[0], head_type="node",
                                    node_arch="conv")
    with_conv = create_model(dataclasses.replace(mcfg, heads=(conv_head,)),
                             device="cpu")
    first = mcfg.num_conv_layers
    assert hasattr(with_conv, f"conv_{first}")
    assert hasattr(with_conv, "head_0_norm_0") and hasattr(with_conv,
                                                           "head_0_out")
    model = create_model(mcfg, device="cpu")
    assert not model.training
    init = dict(model.state_dict())
    again = create_model(mcfg, device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, init[k]), k  # seeded initialisation
    w = model.conv_0.pre_i.weight.detach()
    assert abs(float(w.std()) - (1.0 / 12) ** 0.5) < 0.1
    # training mode runs: batch statistics, running statistics updated
    model.train()
    out, _ = model(batches(csce_model[0], False)[0])
    assert torch.isfinite(out[0]).all()
    assert float(model.feature_norm_0.mean.abs().max()) > 0  # was zeros
