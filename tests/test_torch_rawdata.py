"""Config-driven loading in the port (ROADMAP A2's LSMS and CFG readers):
the generators of the examples' raw files, the open-boundary radius
graph, the readers' samples, `run_training(config, datasets=None)` and
the refusals of the formats and preprocessing knobs the port lacks,
against the JAX package on the CPU.

Bounds: files byte for byte; radius graphs, samples, min-max and the
completed config bitwise (host numpy); training histories within
rtol 1e-4 / atol 1e-5 (tests/test_torch_train.py's TRAIN_TOL).

Both packages' run_training hand update_config their split lists,
which carry no min-max, so with datasets=None `denormalize_output` turns
off with a warning, although the readers' train split carries the
min-max (`Split`, as JAX's reader objects do).
"""
import copy
import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.datasets.cfgdataset import CFGDataset as JCFGDataset
from hydragnn_tpu.datasets.lsmsdataset import LSMSDataset as JLSMSDataset
from hydragnn_tpu.graphs.radius import radius_graph as j_radius_graph
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.preprocess import transforms as jtf
from hydragnn_tpu_torch.datasets.cfgdataset import CFGDataset
from hydragnn_tpu_torch.datasets.lsmsdataset import LSMSDataset, Split
from hydragnn_tpu_torch.graphs.radius import radius_graph
from hydragnn_tpu_torch.graphs.synthetic import (fept_lsms_files,
                                                 ninb_cfg_files)
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.preprocess import transforms as ttf
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_train import TRAIN_TOL, numpy_tree

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EAM = ROOT / "examples" / "eam" / "NiNb_EAM_energy.json"
LSMS = ROOT / "examples" / "lsms" / "lsms.json"
SAMPLE_FIELDS = ("x", "pos", "senders", "receivers", "edge_attr",
                 "edge_shifts", "y_graph", "y_node", "cell", "energy",
                 "forces")
SGD = {"type": "SGD", "learning_rate": 0.01}


def _config(path, **arch):
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["Visualization"]["create_plots"] = False
    cfg["Verbosity"] = {"level": 0}
    cfg["NeuralNetwork"]["Architecture"].update(arch)
    return cfg


def _files(directory):
    return sorted(f for f in os.listdir(directory) if f != ".synthetic")


@pytest.mark.parametrize("kw", [
    dict(num_configs=4),
    dict(num_configs=3, with_forces=True, with_bulk=True, seed=7),
    dict(num_configs=2, cells_per_dim=3, jitter=0.1, seed=2)])
def test_ninb_cfg_files_byte_identical(tmp_path, kw):
    from examples.eam.eam_data import generate_ninb_dataset
    generate_ninb_dataset(str(tmp_path / "jax"), **kw)
    ninb_cfg_files(str(tmp_path / "port"), **kw)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and names
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("kw", [dict(num_configs=4),
                                dict(num_configs=3, atoms_per_dim=3,
                                     seed=5)])
def test_fept_lsms_files_byte_identical(tmp_path, kw):
    from examples.lsms.lsms_data import generate_fept_dataset
    generate_fept_dataset(str(tmp_path / "jax"), **kw)
    fept_lsms_files(str(tmp_path / "port"), **kw)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and names
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("max_neighbours", [None, 0, 3, 12])
@pytest.mark.parametrize("n", [1, 9, 300, 512, 513, 900])
def test_radius_graph_bitwise(n, max_neighbours, loop):
    """Both sides of the dense / cell-list boundary (512 atoms), with and
    without the cap and self loops; a lattice part makes distances tie,
    so the cap's order among equal d² shows."""
    rng = np.random.RandomState(n)
    pos = rng.rand(n, 3) * (n ** (1 / 3)) * 1.2
    pos[: n // 3] = np.round(pos[: n // 3] * 2) / 2
    for dtype in (np.float32, np.float64):
        got = radius_graph(pos.astype(dtype), 1.1, max_neighbours, loop)
        want = j_radius_graph(pos.astype(dtype), 1.1, max_neighbours, loop)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype
            np.testing.assert_array_equal(a, w)


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in SAMPLE_FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            if vb is None:
                assert va is None, f
                continue
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)


@pytest.mark.parametrize("variant", ["energy", "rotation", "descriptors",
                                     "bulk"])
def test_cfg_dataset_matches_jax_bitwise(tmp_path, variant):
    """The CFG reader on the eam files: every sample's fields and the
    min-max bitwise, with the config's PBC radius graph and edge lengths,
    rotation normalization (the cell co-rotated), the two edge
    descriptors, and a `.bulk` graph target."""
    cfg = _config(EAM)
    ds = cfg["Dataset"]
    kw = {}
    if variant == "rotation":
        ds["rotational_invariance"] = True
    if variant == "descriptors":
        ds["rotational_invariance"] = False
        ds["Descriptors"] = ["SphericalCoordinates", "PointPairFeatures"]
    if variant == "bulk":
        kw = dict(with_forces=True, with_bulk=True)
        ds["graph_features"] = {"name": ["bulk"], "dim": [1],
                                "column_index": [2]}
        cfg["NeuralNetwork"]["Variables_of_interest"].update(
            output_names=["bulk"], output_index=[0], type=["graph"])
    ninb_cfg_files(str(tmp_path), 6, seed=3, **kw)
    got, want = CFGDataset(cfg, str(tmp_path)), JCFGDataset(cfg,
                                                            str(tmp_path))
    _assert_samples_equal(list(got), list(want))
    for k in ("minmax_node_feature", "minmax_graph_feature"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert got[0].edge_attr.shape[1] == (8 if variant == "descriptors"
                                         else 1)


@pytest.mark.parametrize("fmt", ["LSMS", "unit_test"])
def test_lsms_dataset_matches_jax_bitwise(tmp_path, fmt):
    """The LSMS reader on the FePt files (open boundaries, radius 7,
    max_neighbours 100; the charge-density column adjusted for FePt):
    samples and min-max bitwise."""
    cfg = _config(LSMS)
    cfg["Dataset"]["format"] = fmt
    fept_lsms_files(str(tmp_path), 8, seed=1)
    got, want = LSMSDataset(cfg, str(tmp_path)), JLSMSDataset(cfg,
                                                              str(tmp_path))
    _assert_samples_equal(list(got), list(want))
    np.testing.assert_array_equal(got.minmax_node_feature,
                                  want.minmax_node_feature)
    np.testing.assert_array_equal(got.minmax_graph_feature,
                                  want.minmax_graph_feature)


def test_transforms_match_jax_bitwise():
    """normalize_rotation (with its rotation), the two descriptors and
    normalize_edge_lengths over a dataset, on random structures."""
    rng = np.random.RandomState(9)
    for _ in range(5):
        pos = (rng.randn(17, 3) * 2).astype(np.float32)
        a, ra = ttf.normalize_rotation(pos, return_rotation=True)
        b, rb = jtf.normalize_rotation(pos, return_rotation=True)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ra, rb)
        send, recv = radius_graph(pos, 3.0)
        vec = pos[send] - pos[recv]
        np.testing.assert_array_equal(ttf.spherical_coordinates(vec),
                                      jtf.spherical_coordinates(vec))
        np.testing.assert_array_equal(
            ttf.point_pair_features(pos, vec, send, recv),
            jtf.point_pair_features(pos, vec, send, recv))


@pytest.mark.parametrize("which", ["eam", "lsms"])
def test_run_training_from_files_matches_jax(tmp_path, monkeypatch, which):
    """run_training(config, datasets=None, device="cpu") on the example's
    own files under a relative Dataset.path (the working directory's
    dataset/...), 2 epochs of SGD at a cut width, against the JAX
    package's run_training on the same directory from the same Flax
    variables: the completed config bitwise (the splits complete it as
    plain lists, so the reader's min-max does not reach it and
    `denormalize_output` turns off, as in JAX), the histories within
    TRAIN_TOL, and run_prediction from the files giving the normalized
    targets."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    if which == "eam":
        cfg = _config(EAM, hidden_dim=8, num_conv_layers=2)
        cfg["NeuralNetwork"]["Architecture"]["output_heads"]["node"][
            "dim_headlayers"] = [8, 8]
        ninb_cfg_files(os.path.join("dataset", "NiNb_solid_solution"), 40)
    else:
        cfg = _config(LSMS, num_conv_layers=2)
        cfg["NeuralNetwork"]["Training"]["EarlyStopping"] = False
        fept_lsms_files(os.path.join("dataset", "FePt_enthalpy"), 40)
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=2, batch_size=8, Optimizer=dict(SGD), keep_best=False)
    jrun = importlib.import_module("hydragnn_tpu.run_training")
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    inits = []

    def spy_init(*args, **kwargs):
        inits.append(numpy_tree(j_init_params(*args, **kwargs)))
        return jax.tree_util.tree_map(jnp.asarray, inits[-1])
    monkeypatch.setattr(jrun, "init_params", spy_init)
    _, jhist, _, jdone = jrun.run_training(copy.deepcopy(cfg), num_shards=1)

    def port_model(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(inits[0]))
        return model
    monkeypatch.setattr(prun, "create_model", port_model)
    state, hist, model, done = prun.run_training(copy.deepcopy(cfg),
                                                 device="cpu")
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], err_msg=key,
                                   **TRAIN_TOL)
    assert hist["lr"] == jhist["lr"]

    # the splits complete the config as plain lists, as in JAX: the
    # reader's min-max does not reach it and denormalization turns off
    assert cfg["NeuralNetwork"]["Variables_of_interest"][
        "denormalize_output"]
    voi = done["NeuralNetwork"]["Variables_of_interest"]
    assert not voi["denormalize_output"] and "y_minmax" not in voi
    assert done == jdone

    from hydragnn_tpu_torch import run_prediction
    trues, preds = run_prediction(copy.deepcopy(cfg), state=state,
                                  model=model, device="cpu")
    train, _, test = prun.load_datasets_from_config(cfg)
    assert isinstance(train, Split)
    assert train.minmax_node_feature is not None
    node_col = 0
    for ih, otype in enumerate(voi["type"]):
        if otype == "graph":
            norm = np.stack([s.y_graph[:1] for s in test])
        else:
            norm = np.concatenate([s.y_node[:, node_col:node_col + 1]
                                   for s in test])
            node_col += 1
        assert np.isfinite(preds[ih]).all()
        np.testing.assert_array_equal(trues[ih], norm)


# (config change, env) -> what run_training(datasets=None) raises; each
# raises before any file is read (the Dataset.path does not exist)
REFUSALS = [
    # XYZ reads now (tests/test_torch_xyz.py): the run reaches the
    # (missing) files
    ({"format": "XYZ"}, {}, FileNotFoundError, "no .xyz files"),
    ({"format": "pickle"}, {}, NotImplementedError, "A10"),
    ({"format": "adios"}, {}, NotImplementedError, "A10"),
    ({"format": "nope"}, {}, ValueError, "unsupported"),
    ({}, {"HYDRAGNN_PREPROC_WORKERS": "2"}, NotImplementedError, "A10"),
    ({"preprocess_workers": 4}, {}, NotImplementedError, "A10"),
    ({}, {"HYDRAGNN_PREPROC_CACHE_DIR": "cache"}, NotImplementedError,
     "A10"),
    ({"preprocessed_cache_dir": "cache"}, {}, NotImplementedError, "A10"),
    # 0 and 1 workers build serially, as JAX's do: accepted, and the run
    # reaches the (missing) files
    ({"preprocess_workers": 1}, {}, FileNotFoundError, "no .cfg files"),
    ({}, {"HYDRAGNN_PREPROC_WORKERS": "0"}, FileNotFoundError,
     "no .cfg files"),
]


@pytest.mark.parametrize("change,env,exc,match", REFUSALS)
def test_unported_formats_and_preprocessing_knobs_raise(
        tmp_path, monkeypatch, change, env, exc, match):
    from hydragnn_tpu_torch import run_prediction, run_training
    monkeypatch.chdir(tmp_path)
    for name in ("HYDRAGNN_PREPROC_WORKERS", "HYDRAGNN_PREPROC_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = _config(EAM)
    for key, value in change.items():
        section = (cfg["NeuralNetwork"]["Training"]
                   if key == "preprocess_workers" else cfg["Dataset"])
        section[key] = value
    with pytest.raises(exc, match=match):
        run_training(copy.deepcopy(cfg), device="cpu")
    with pytest.raises(exc, match=match):
        run_prediction(copy.deepcopy(cfg), device="cpu")
    assert not os.path.exists("cache")
