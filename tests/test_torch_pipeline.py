"""The port's pipeline parallelism, its pure pieces and its forward
(hydragnn_tpu_torch/parallel/pipeline.py, pipeline_trainer.py's model,
utils/envflags.resolve_pipeline, utils/weights.py's pipelined tree),
against the JAX package on the CPU, the stages all on the CPU:

* the closed forms, their errors and `resolve_pipeline` over a grid of
  knobs: bitwise (equal values, equal messages, equal warnings);
* the pipelined forward against the sequential one: bitwise, for GIN,
  SAGE, PNA (dense and edge list), SchNet and equivariant SchNet; and
  against JAX's `make_pipeline_forward` on the same weights within rtol
  1e-5 / atol 1e-6, PNA and SchNet within the port's standing stack
  bound against JAX, rtol 1e-4 / atol 1e-5 (PNA's std near a zero
  variance scales float32 rounding; SchNet's filter sums round in
  another order than XLA's; measured 2.0e-5 and 2.3e-5 relative);
* remat on against off, "full" and "dots": values and gradients bitwise
  on random floats; the schedule's gpipe and 1f1b gradients bitwise each
  other and the sequential stack on exactly representable data;
* the pipelined tree's load / export round trip: bitwise.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import pipeline as jpipe
from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu.utils import envflags as jenv
from hydragnn_tpu_torch.datasets.loader import unstack_batch
from hydragnn_tpu_torch.parallel import pipeline as tpipe
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from hydragnn_tpu_torch.utils import envflags as tenv
from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                              load_jax_variables)
from tests.torch_pipeline_fixtures import (CPU, PARAM_TOL, Fixture, S,
                                           flat, tol_for)

torch.set_num_threads(1)


# ------------------------------------------------------ closed forms --
def test_closed_forms_bitwise_jax():
    for stages in range(1, 6):
        for micro in range(1, 10):
            assert tpipe.forward_ticks(stages, micro) == \
                jpipe.forward_ticks(stages, micro)
            assert tpipe.bubble_fraction(stages, micro) == \
                jpipe.bubble_fraction(stages, micro)
            for sched in ("gpipe", "1f1b"):
                assert tpipe.train_step_ticks(stages, micro, sched) == \
                    jpipe.train_step_ticks(stages, micro, sched)
                assert tpipe.train_bubble_fraction(stages, micro, sched) \
                    == jpipe.train_bubble_fraction(stages, micro, sched)
            assert tpt.pipeline_window_size(stages, micro) == \
                jpt.pipeline_window_size(stages, micro)
        for layers in range(1, 13):
            try:
                want = jpipe.check_stage_divisibility(layers, stages)
            except ValueError as exc:
                with pytest.raises(ValueError) as got:
                    tpipe.check_stage_divisibility(layers, stages)
                assert str(got.value) == str(exc)
            else:
                assert tpipe.check_stage_divisibility(layers, stages) == want


@pytest.mark.parametrize("call", [
    lambda m: m.check_stage_divisibility(4, 0),
    lambda m: m.train_step_ticks(2, 4, "interleaved"),
    lambda m: m.resolve_remat_policy("dotz"),
])
def test_closed_form_errors_carry_jax_messages(call):
    with pytest.raises(ValueError) as want:
        call(jpipe)
    with pytest.raises(ValueError) as got:
        call(tpipe)
    assert str(got.value) == str(want.value)


_KNOB_ENVS = ("HYDRAGNN_PIPE_MICROBATCHES", "HYDRAGNN_PIPE_SCHEDULE",
              "HYDRAGNN_PIPE_REMAT")
_KNOB_GRID = [
    ({}, {}, 4),
    ({"pipeline_microbatches": 8, "pipeline_schedule": "gpipe",
      "pipeline_remat": "dots", "pipeline_data_shards": 2}, {}, 4),
    ({"pipeline_remat": True}, {}, 4),
    ({"pipeline_remat": "dotz"}, {}, 4),
    ({"pipeline_remat": ""}, {}, 2),
    ({}, {"HYDRAGNN_PIPE_MICROBATCHES": "16",
          "HYDRAGNN_PIPE_SCHEDULE": "1f1b", "HYDRAGNN_PIPE_REMAT": "1"}, 4),
    ({"pipeline_microbatches": 8}, {
        "HYDRAGNN_PIPE_MICROBATCHES": "eight",
        "HYDRAGNN_PIPE_SCHEDULE": "1f1b_typo",
        "HYDRAGNN_PIPE_REMAT": "ture"}, 4),
    ({"pipeline_microbatches": 6}, {}, 4),
    ({"pipeline_microbatches": 6, "pipeline_schedule": "1f1b"}, {}, 4),
    ({"pipeline_microbatches": 6}, {"HYDRAGNN_PIPE_SCHEDULE": "gpip"}, 4),
    ({"pipeline_microbatches": 6, "pipeline_schedule": None}, {}, 4),
    ({"pipeline_microbatches": 6, "pipeline_schedule": "  "}, {}, 4),
    ({}, {"HYDRAGNN_PIPE_SCHEDULE": "", "HYDRAGNN_PIPE_REMAT": " ",
          "HYDRAGNN_PIPE_MICROBATCHES": ""}, 3),
    ({"pipeline_microbatches": 0}, {"HYDRAGNN_PIPE_REMAT": "DOTS",
                                    "HYDRAGNN_PIPE_SCHEDULE": "GPipe"}, 2),
    ({"pipeline_remat": "off"}, {"HYDRAGNN_PIPE_MICROBATCHES": "0"}, 3),
]


@pytest.mark.parametrize("train_cfg,env,stages", _KNOB_GRID)
def test_resolve_pipeline_matches_jax(monkeypatch, caplog, train_cfg, env,
                                      stages):
    """HYDRAGNN_PIPE_* over Training.* over the defaults, strict parsing
    (a typo or an empty value warns and falls back), the gpipe fall-back
    of a defaulted 1f1b: the JAX resolver's result and warnings."""
    for var in _KNOB_ENVS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        want = jenv.resolve_pipeline(dict(train_cfg), stages)
        jwarn = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = tenv.resolve_pipeline(dict(train_cfg), stages)
        twarn = [r.getMessage() for r in caplog.records]
    assert got == want
    assert twarn == jwarn


# ------------------------------------------------------------ forward --
FORWARD_CASES = [("GIN", True, False), ("SAGE", False, False),
                 ("PNA", True, False), ("PNA", False, False),
                 ("SchNet", True, False), ("SchNet", False, False),
                 ("SchNet", False, True)]


@pytest.mark.parametrize("model_type,dense,ef", FORWARD_CASES)
def test_forward_pipelined_bitwise_sequential_and_matches_jax(
        model_type, dense, ef):
    fx = Fixture(model_type, dense=dense, ef=ef)
    model = fx.model()
    micros = unstack_batch(fx.stacked)
    with torch.no_grad():
        got = tpt.make_pipeline_forward(model, pipelined=True)(micros)
        seq = tpt.make_pipeline_forward(model, pipelined=False)(micros)
    want, _ = jpt.make_pipeline_forward(fx.jmcfg, fx.mesh, S)(
        fx.params, fx.jstacked)
    tol = tol_for(model_type)
    for m in range(len(micros)):
        for ih, (a, b) in enumerate(zip(got[m][0], seq[m][0])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_allclose(a.numpy(), np.asarray(want[ih][m]),
                                       err_msg=f"micro {m} head {ih}", **tol)


def test_forward_node_head_and_stacked_devices_placement():
    """An mlp node head, and the model's blocks on their stages."""
    fx = Fixture("GIN", heads=("graph", "node"))
    model = fx.model()
    assert [b.LayerNorm_0.scale.device.type for b in model.convs] == \
        ["cpu"] * 4
    assert [len(s) for s in model.stage_layers()] == [2, 2]
    micros = unstack_batch(fx.stacked)
    with torch.no_grad():
        got = tpt.make_pipeline_forward(model)(micros)
    want, _ = jpt.make_pipeline_forward(fx.jmcfg, fx.mesh, S)(
        fx.params, fx.jstacked)
    for m in range(len(micros)):
        assert got[m][0][1].shape == (fx.stacked.x.shape[1], 1)
        for ih in range(2):
            np.testing.assert_allclose(got[m][0][ih].numpy(),
                                       np.asarray(want[ih][m]), **PARAM_TOL)


def test_layer_norm_is_flax_layer_norm():
    import flax.linen as fnn
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(37, 16)) * 3 + 1).astype(np.float32)
    x[5] = 2.5   # a constant row: the variance clips at 0
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}},
                                 x)
    ln = tpt.LayerNorm(16)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # bf16 in, float32 statistics, bf16 out
    with torch.no_grad():
        out = tpt.LayerNorm(16).to(torch.bfloat16)(
            torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# -------------------------------------------------------------- remat --
def _loss(outs):
    return sum((o[0][0] ** 2).sum() for o in outs)


@pytest.mark.parametrize("model_type,dense,ef", [
    ("GIN", True, False), ("PNA", True, False), ("SchNet", False, True)])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_bitwise_values_and_gradients(model_type, dense, ef, policy):
    """Checkpointed ticks recompute the same ops: values and gradients
    bitwise remat off, on random floats (the hand-written kernels'
    Functions are invisible to the dots policy and recomputed)."""
    fx = Fixture(model_type, dense=dense, ef=ef)
    model = fx.model()
    micros = unstack_batch(fx.stacked)
    params = list(model.parameters())
    results = []
    for remat in (False, True):
        fwd = tpt.make_pipeline_forward(model, remat=remat,
                                        remat_policy=policy)
        outs = fwd(micros)
        grads = torch.autograd.grad(_loss(outs), params, allow_unused=True,
                                    materialize_grads=True)
        results.append(([o[0][0].detach() for o in outs], grads))
    (v0, g0), (v1, g1) = results
    for a, b in zip(v0, v1):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert any(float(g.abs().max()) > 0 for g in g0)


# integer inputs, quarter-integer weights, one in-edge a node: every
# value and gradient product of the toy stack is exact in float32, so
# reassociating the window sums cannot round (the JAX package's
# exact-data contract, tests/test_pipeline.py)
_ME, _SE, _N, _F = 8, 4, 16, 8


def _exact_problem(seed=0, layers=4):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-1, 2, (_ME, _N, _F)).astype(
        np.float32))
    send = [torch.from_numpy(rng.permutation(_N)) for _ in range(_ME)]
    recv = [torch.from_numpy(rng.permutation(_N)) for _ in range(_ME)]
    layers_ = []
    for _ in range(layers):
        lin = torch.nn.Linear(_F, _F)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(
                (rng.randint(-1, 2, (_F, _F)) * 0.25).astype(np.float32)))
            lin.bias.copy_(torch.from_numpy(
                (rng.randint(-1, 2, (_F,)) * 0.25).astype(np.float32)))
        layers_.append(lin)
    return x, list(zip(send, recv)), layers_


def _exact_layer(lin, h, st):
    send, recv = st
    agg = torch.zeros_like(h).index_add_(0, recv, h[send])
    return torch.relu(lin(h + agg))


@pytest.mark.parametrize("remat", [False, True])
def test_schedule_gradients_bitwise_on_exact_data(remat):
    """gpipe (one backward) and 1f1b (windows of S, float32 sums) give
    the sequential stack's gradients bit for bit on exact data."""
    x, structure, layers = _exact_problem()
    params = [p for lin in layers for p in lin.parameters()]
    apply = tpipe.make_pipeline_apply(["cpu"] * _SE, _exact_layer, 4,
                                      remat=remat)
    stage_layers = [[layers[s]] for s in range(_SE)]
    per_stage = [structure] * _SE

    def seq(xs, sts):
        outs = []
        for h, st in zip(xs, sts):
            for lin in layers:
                h = _exact_layer(lin, h, st)
            outs.append(h)
        return outs
    y_seq = seq(list(x), structure)
    y_pipe = apply(stage_layers, list(x), per_stage)
    for a, b in zip(y_pipe, y_seq):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())

    def grads(outs):
        return torch.autograd.grad(
            torch.stack([(o ** 2).sum() for o in outs]).sum() / _ME, params)
    g_seq = grads(y_seq)
    g_gpipe = grads(y_pipe)
    g_1f1b = [torch.zeros_like(p) for p in params]
    for w in range(_ME // _SE):
        sl = slice(w * _SE, (w + 1) * _SE)
        outs = apply(stage_layers, list(x[sl]),
                     [structure[sl]] * _SE)
        torch._foreach_add_(g_1f1b, list(grads(outs)))
    for name, g in (("gpipe", g_gpipe), ("1f1b", g_1f1b)):
        for a, b in zip(g, g_seq):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=name)
    assert any(float(g.abs().max()) > 0 for g in g_seq)


def test_1f1b_window_divisibility_actionable_error():
    with pytest.raises(ValueError, match="multiple of the stage count"):
        tpt._schedule_grads(None, [], [None] * 6, "1f1b", 4, [])


# ------------------------------------------------------------ weights --
@pytest.mark.parametrize("model_type,ef", [("GIN", False), ("PNA", False),
                                           ("SchNet", True)])
def test_weights_round_trip_bitwise(model_type, ef):
    """load_jax_variables unstacks the [L] axis of `convs` into the
    blocks; export_jax_variables stacks it again, bit for bit (GIN's 0-d
    eps included)."""
    fx = Fixture(model_type, ef=ef)
    model = fx.model()
    back = export_jax_variables(model)
    assert set(back["params"]) == {"embed", "convs", "heads"}
    assert back["batch_stats"] == {}
    leaves = jax.tree_util.tree_leaves_with_path(fx.params)
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(leaves)
    for path, arr in leaves:
        assert got[path].shape == np.asarray(arr).shape, path
        np.testing.assert_array_equal(got[path], np.asarray(arr))
    again = load_jax_variables(back)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_random_flax_variables_of_a_pipelined_model_stack():
    from hydragnn_tpu_torch.utils.weights import random_flax_variables
    fx = Fixture("GIN")
    model = fx.model()
    tree = random_flax_variables(model, seed=5)
    assert tree["params"]["convs"]["conv"]["eps"].shape == (4,)
    model.load_state_dict(load_jax_variables(tree))
    np.testing.assert_array_equal(flat(export_jax_variables(model)["params"]),
                                  flat(tree["params"]))


def test_model_stage_devices_and_structure():
    fx = Fixture("SchNet", dense=False)
    model = fx.model(devices=CPU)
    micros = unstack_batch(fx.stacked)
    st = model.structure(micros)
    assert len(st) == S and len(st[0]) == len(micros)
    # one device: the structure is built once and shared by the stages
    assert st[0] is st[1]
    assert set(st[0][0][1]) == {"edge_length", "filter_layout",
                                "segment_layout"}
