"""The port's XYZ reader (datasets/xyzdataset.py) against the JAX
package's on the CPU: samples, min-max and splits bitwise on
directories of `.xyz` files with `_energy.txt` sidecars, the sidecar
errors, and `run_training(config)` / `run_prediction(config)` reading
`Dataset.format` "XYZ" from the files (histories within rtol 1e-4 /
atol 1e-5, tests/test_torch_train.py's TRAIN_TOL; the completed config
bitwise).
"""
import copy
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.datasets import xyzdataset as jxyz
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu_torch.datasets import xyzdataset as txyz
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_extxyz import assert_samples_equal
from tests.test_torch_train import TRAIN_TOL, numpy_tree
from tests.utils import BASE_CONFIG

torch.set_num_threads(1)


def write_xyz_dir(path, num, seed=0, lattice=True, numbers=False,
                  columns=1):
    """`num` structures of 4-9 atoms of H, C, N or O in a 4 A box, each
    `s<i>.xyz` with a `s<i>_energy.txt` sidecar of `columns` values."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(num):
        n = rng.randint(4, 10)
        zs = rng.choice([1, 6, 7, 8], n)
        pos = rng.rand(n, 3) * 4
        sym = {1: "H", 6: "C", 7: "N", 8: "O"}
        with open(os.path.join(path, f"s{i:03d}.xyz"), "w") as f:
            f.write(f"{n}\n")
            f.write('Lattice="4 0 0 0 4 0 0 0 4" Properties=species:S:1:'
                    'pos:R:3\n' if lattice else "a comment\n")
            for z, p in zip(zs, pos):
                tok = str(z) if numbers else sym[int(z)]
                f.write(f"{tok} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        with open(os.path.join(path, f"s{i:03d}_energy.txt"), "w") as f:
            f.write(" ".join(f"{v:.6f}" for v in rng.randn(columns)) + "\n")


def xyz_config(path, column=0, **arch):
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["Dataset"].update(
        name="xyz_test", format="XYZ", path={"total": str(path)},
        node_features={"name": ["Z"], "dim": [1], "column_index": [0]},
        graph_features={"name": ["energy"], "dim": [1],
                        "column_index": [column]})
    cfg["NeuralNetwork"]["Architecture"].update(radius=2.5,
                                                max_neighbours=12, **arch)
    return cfg


@pytest.mark.parametrize("lattice,numbers,column", [
    (True, False, 0), (False, True, 1), (True, True, 2)])
def test_xyz_dataset_and_splits_match_jax_bitwise(tmp_path, lattice,
                                                  numbers, column):
    """XYZDataset: samples and the graph min-max bitwise (cells from the
    Lattice comment or none, symbols or atomic numbers, a sidecar column
    picked by `graph_features.column_index`); load_xyz_splits gives
    JAX's splits as plain lists."""
    write_xyz_dir(tmp_path, 14, seed=column, lattice=lattice,
                  numbers=numbers, columns=3)
    cfg = xyz_config(tmp_path, column)
    got, want = txyz.XYZDataset(cfg, str(tmp_path)), \
        jxyz.XYZDataset(cfg, str(tmp_path))
    assert_samples_equal(list(got), list(want))
    assert got.minmax_node_feature is None
    np.testing.assert_array_equal(got.minmax_graph_feature,
                                  want.minmax_graph_feature)
    assert (got[0].cell is not None) == lattice
    for a, b in zip(txyz.load_xyz_splits(cfg), jxyz.load_xyz_splits(cfg)):
        assert isinstance(a, list)
        assert_samples_equal(a, b)
    assert txyz.parse_xyz_file(str(tmp_path / "s000.xyz"))[0].shape[1] == 1


def test_xyz_sidecar_errors_match_jax(tmp_path):
    """Sidecars partly present, or absent under a graph head, raise as
    in the JAX package; no .xyz file raises FileNotFoundError."""
    write_xyz_dir(tmp_path / "a", 4)
    os.remove(tmp_path / "a" / "s001_energy.txt")
    cfg = xyz_config(tmp_path / "a")
    for mod in (txyz, jxyz):
        with pytest.raises(ValueError, match="sidecars"):
            mod.XYZDataset(cfg, str(tmp_path / "a"))
    write_xyz_dir(tmp_path / "b", 3)
    for f in os.listdir(tmp_path / "b"):
        if f.endswith("_energy.txt"):
            os.remove(tmp_path / "b" / f)
    for mod in (txyz, jxyz):
        with pytest.raises(FileNotFoundError, match="graph target"):
            mod.XYZDataset(cfg, str(tmp_path / "b"))
    os.makedirs(tmp_path / "c")
    with pytest.raises(FileNotFoundError, match="no .xyz"):
        txyz.XYZDataset(cfg, str(tmp_path / "c"))


def test_run_training_reads_xyz_files_as_jax(tmp_path, monkeypatch):
    """run_training(config) with Dataset.format "XYZ" and no datasets
    reads the directory (a relative path, from the working directory),
    trains 2 epochs of SGD from JAX's initial variables: histories
    within TRAIN_TOL and the completed config bitwise JAX's;
    run_prediction(config) reads the files again and predicts the test
    split's targets' shape."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    for name in ("HYDRAGNN_PREPROC_WORKERS", "HYDRAGNN_PREPROC_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    write_xyz_dir(os.path.join("dataset", "xyz"), 30, seed=4)
    cfg = xyz_config(os.path.join("dataset", "xyz"), hidden_dim=8,
                     num_conv_layers=2)
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=2, batch_size=4, EarlyStopping=False, keep_best=False,
        Optimizer={"type": "SGD", "learning_rate": 0.01})
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
    assert done == jdone
    from hydragnn_tpu_torch import run_prediction
    trues, preds = run_prediction(copy.deepcopy(cfg), state=state,
                                  model=model, device="cpu")
    _, _, test = txyz.load_xyz_splits(cfg)
    assert trues[0].shape == preds[0].shape == (len(test), 1)
    assert np.isfinite(preds[0]).all()
