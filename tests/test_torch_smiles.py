"""The port's SMILES featurizer (utils/smiles_utils.py), the csce and
ogb CSV readers (datasets/smiles.py) and generators
(graphs/synthetic.py), against the JAX package's and the examples' on
the CPU, and a PNA forward on featurized csce bond graphs against JAX's.

Bounds: CSVs byte for byte, parses and samples bitwise (host numpy);
the PNA forward within rtol 1e-4 / atol 1e-5 (tests/test_torch_train.py's
TRAIN_TOL). Only the built-in parser is held: rdkit is not installed.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from examples.csce import csce_data
from examples.ogb import ogb_data
from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.utils import smiles_utils as jsmiles
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets import smiles as tsmiles_data
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs import synthetic
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.utils import smiles_utils as tsmiles
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_extxyz import assert_samples_equal
from tests.test_torch_train import (TRAIN_TOL, _jax_view, jax_batch,
                                    numpy_tree)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSCE = ROOT / "examples" / "csce" / "csce_gap.json"
# aromatic rings, ring closures (digits and %nn), branches, brackets
# with isotopes and charges, triple and double bonds, disconnected parts,
# stereo marks, and elements outside the csce dictionary
HAND_PICKED = [
    "c1ccccc1", "c1ccncc1O", "C1CC1C(=O)O", "CC(C)(C)C#N", "C=CC=C",
    "OCC.N", "C/C=C/C", "F[C@H](Cl)Br", "[13CH4]", "[NH4+]", "[O-]C=O",
    "C%10CCCCC%10", "c1ccc2ccccc2c1", "CS(=O)(=O)N", "N#CC#N", "[Na+].[Cl-]",
    "B(O)O", "P(=O)(O)O", "c1cc[nH]c1", "C1=CC=CC=C1", "ClC(Br)I",
    "[Se]", "CC(=O)Oc1ccccc1C(=O)O",
]


@pytest.mark.parametrize("seed", [0, 9])
def test_csce_and_ogb_generators_write_the_examples_bytes(tmp_path, seed):
    """generate_csce_csv and generate_ogb_csv write the examples' CSVs
    (and markers) byte for byte, for two seeds."""
    a = synthetic.generate_csce_csv(str(tmp_path / "p"), 40, seed=seed)
    b = csce_data.generate_csce_csv(str(tmp_path / "j"), 40, seed=seed)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert Path(a).relative_to(tmp_path / "p") == \
        Path(b).relative_to(tmp_path / "j")
    a = synthetic.generate_ogb_csv(str(tmp_path / "p"), 40, seed=seed)
    b = ogb_data.generate_ogb_csv(str(tmp_path / "j"), 40, seed=seed)
    for name in ("pcqm4m_gap_synth.csv", ".synthetic"):
        assert (Path(a) / name).read_bytes() == (Path(b) / name).read_bytes()


@pytest.mark.parametrize("smiles", HAND_PICKED)
def test_hand_picked_smiles_match_jax_bitwise(smiles):
    """parse_smiles, the implicit hydrogens and the features (with the
    csce and the ogb dictionaries) equal the JAX package's, and a
    molecule outside a dictionary raises the same error."""
    assert tsmiles.parse_smiles(smiles) == jsmiles.parse_smiles(smiles)
    parsed = jsmiles.parse_smiles(smiles)
    assert tsmiles._add_implicit_hydrogens(*parsed) == \
        jsmiles._add_implicit_hydrogens(*parsed)
    for types in (list(tsmiles_data.CSCE_NODE_TYPES),
                  list(tsmiles_data.OGB_NODE_TYPES), None):
        try:
            want = jsmiles.generate_graphdata_from_smilestr(
                smiles, y=np.asarray([0.5], np.float32), types=types)
        except (KeyError, ValueError) as exc:
            with pytest.raises(type(exc)):
                tsmiles.generate_graphdata_from_smilestr(
                    smiles, y=np.asarray([0.5], np.float32), types=types)
            continue
        got = tsmiles.generate_graphdata_from_smilestr(
            smiles, y=np.asarray([0.5], np.float32), types=types)
        assert_samples_equal([got], [want])
    assert tsmiles.get_node_attribute_name() == \
        jsmiles.get_node_attribute_name()
    assert tsmiles.get_node_attribute_name(["C", "O"]) == \
        jsmiles.get_node_attribute_name(["C", "O"])


def test_unsupported_atom_raises_as_jax():
    for smiles in ("[Xx]", "Q"):
        try:
            jsmiles.parse_smiles(smiles)
            want = None
        except ValueError as exc:
            want = type(exc)
        if want is None:
            assert tsmiles.parse_smiles(smiles) == \
                jsmiles.parse_smiles(smiles)
        else:
            with pytest.raises(want):
                tsmiles.parse_smiles(smiles)


@pytest.mark.parametrize("norm,sampling", [(False, None), (True, 0.7)])
def test_csce_splits_match_the_example_bitwise(tmp_path, norm, sampling):
    """The csce CSV -> (train, val, test) samples: the example's
    csce_datasets_load + smiles_sets_to_graphs with the 6-type
    dictionary, bitwise, normalized or not, sampled or not."""
    path = synthetic.generate_csce_csv(str(tmp_path), 120, seed=4)
    sets, vals, mean, std = csce_data.csce_datasets_load(path, sampling)
    want = csce_data.smiles_sets_to_graphs(
        sets, vals, norm_yflag=norm, ymean=mean, ystd=std,
        types=list(csce_data.CSCE_NODE_TYPES))
    got = tsmiles_data.csce_splits(path, sampling=sampling,
                                   norm_yflag=norm)
    assert len(got) == 3 and sum(len(s) for s in got) > 0
    for g, w in zip(got, want):
        assert_samples_equal(g, w)
    tsets, tvals, tmean, tstd = tsmiles_data.csce_datasets_load(path,
                                                               sampling)
    assert tsets == sets and (tmean, tstd) == (mean, std)
    for a, b in zip(tvals, vals):
        np.testing.assert_array_equal(a, b)
    assert got[0][0].x.shape[1] == 12 and got[0][0].edge_attr.shape[1] == 4


def test_ogb_samples_match_the_example_bitwise(tmp_path):
    """smiles_to_graphs over the ogb CSV directory (NaN and malformed
    gaps skipped, a limit) with the 31-type dictionary, bitwise."""
    d = synthetic.generate_ogb_csv(str(tmp_path), 80, seed=6)
    with open(Path(d) / "pcqm4m_gap_synth.csv", "a") as f:
        f.write("CCO,nan\nCCN,abc\n[Xx]C,1.0\n")
    assert_samples_equal(tsmiles_data.smiles_to_graphs(str(tmp_path)),
                         ogb_data.smiles_to_graphs(str(tmp_path)))
    assert_samples_equal(
        tsmiles_data.smiles_to_graphs(str(tmp_path), limit=7),
        ogb_data.smiles_to_graphs(str(tmp_path), limit=7))


@pytest.mark.parametrize("dense", [True, False])
def test_pna_forward_on_csce_bond_graphs_matches_jax(tmp_path, dense):
    """csce_gap.json's PNA cut to hidden 16 and 2 layers on featurized
    csce batches (the 12 node columns, bond graphs of in-degree <= 4),
    from the same Flax variables: outputs within TRAIN_TOL on both
    layouts."""
    path = synthetic.generate_csce_csv(str(tmp_path), 60, seed=1)
    train, _, _ = tsmiles_data.csce_splits(path)
    jtrain = csce_data.smiles_sets_to_graphs(
        *csce_data.csce_datasets_load(path)[:2],
        types=list(csce_data.CSCE_NODE_TYPES))[0]
    with open(CSCE) as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=2)
    arch["output_heads"]["graph"].update(dim_sharedlayers=16,
                                         dim_headlayers=[16, 16])
    tc = tcfg.update_config(copy.deepcopy(cfg), train)
    jc = jcfg.update_config(copy.deepcopy(cfg), jtrain)
    assert tc == jc
    jmodel = j_create_model(jcfg.build_model_config(jc))
    loader = GraphDataLoader(train, 8, neighbor_format=dense)
    batches = list(loader)[:3]
    variables = numpy_tree(j_init_params(jmodel, jax_batch(
        _jax_view(batches[0])), seed=3))
    model = create_model(tcfg.build_model_config(tc), device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    model.eval()
    for b in batches:
        with torch.no_grad():
            got, _ = model(b)
        want, _ = jmodel.apply(variables, jax_batch(_jax_view(b)),
                               train=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **TRAIN_TOL)
