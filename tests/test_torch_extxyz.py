"""The port's extxyz reader and writer (datasets/extxyz.py), its frame
-> GraphSample (datasets/atomistic.py `frame_to_sample`), the OC20 and
OC22 chunk readers and the generators that write their chunks
(graphs/synthetic.py), against the JAX package's and the examples' on
the CPU. Host numpy: files byte for byte, frames and samples bitwise.
"""
import os

import numpy as np
import pytest

from examples.common_atomistic import frame_to_sample as ex_frame_to_sample
from examples.open_catalyst_2020 import oc20_data
from examples.open_catalyst_2022 import oc22_data
from hydragnn_tpu.datasets import extxyz as jextxyz
from hydragnn_tpu_torch.datasets import atomistic
from hydragnn_tpu_torch.datasets import extxyz as textxyz
from hydragnn_tpu_torch.graphs import synthetic
from tests.test_torch_rawdata import _assert_samples_equal


def assert_samples_equal(got, want):
    """Every field bitwise, dtypes included; a None (a frame whose
    forces trip the threshold) where the other has None."""
    assert [a is None for a in got] == [b is None for b in want]
    _assert_samples_equal([a for a in got if a is not None],
                          [b for b in want if b is not None])


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _frames(seed, n=5, cell=True, extra=True):
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        natoms = rng.randint(2, 9)
        z = rng.choice([1.0, 6.0, 8.0, 29.0, 78.0], natoms).astype(np.float32)
        pos = (rng.randn(natoms, 3) * 3).astype(np.float32)
        arrays = {"forces": rng.randn(natoms, 3).astype(np.float32)}
        if extra:
            arrays["charges"] = rng.randn(natoms, 1).astype(np.float32)
        info = {"energy": float(rng.randn() * 10), "tag": f"f{i}"}
        c = (np.diag(rng.uniform(5, 9, 3)).astype(np.float32) if cell
             else None)
        frames.append(jextxyz.Frame(z, pos, c, arrays, info))
    return frames


@pytest.mark.parametrize("cell,extra", [(True, True), (False, False),
                                        (True, False)])
def test_extxyz_write_and_read_match_jax_bitwise(tmp_path, cell, extra):
    """write_extxyz writes the JAX package's bytes; iread_extxyz and
    read_extxyz read the JAX package's frames (z, pos, cell, per-atom
    arrays and comment scalars) from them, bitwise; a round trip gives
    the frames as written at the format's 8 decimals."""
    frames = _frames(3, cell=cell, extra=extra)
    textxyz.write_extxyz(str(tmp_path / "port.extxyz"), frames)
    jextxyz.write_extxyz(str(tmp_path / "jax.extxyz"), frames)
    assert (tmp_path / "port.extxyz").read_bytes() == \
        (tmp_path / "jax.extxyz").read_bytes()
    got = list(textxyz.iread_extxyz(str(tmp_path / "port.extxyz")))
    want = list(jextxyz.iread_extxyz(str(tmp_path / "port.extxyz")))
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        for name in ("z", "pos"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name))
        assert (g.cell is None) == (w.cell is None) == (f.cell is None)
        if w.cell is not None:
            np.testing.assert_array_equal(g.cell, w.cell)
            np.testing.assert_allclose(g.cell, f.cell, atol=1e-6)
        assert sorted(g.arrays) == sorted(w.arrays) == sorted(f.arrays)
        for k in w.arrays:
            np.testing.assert_array_equal(g.arrays[k], w.arrays[k])
            np.testing.assert_allclose(g.arrays[k], f.arrays[k], atol=1e-7)
        assert g.info == w.info
        np.testing.assert_array_equal(g.z, f.z)
        np.testing.assert_allclose(g.pos, f.pos, atol=1e-6)
    assert len(textxyz.read_extxyz(str(tmp_path / "port.extxyz"),
                                   limit=2)) == 2
    # appending
    textxyz.write_extxyz(str(tmp_path / "port.extxyz"), frames[:1],
                         mode="a")
    assert len(list(textxyz.iread_extxyz(
        str(tmp_path / "port.extxyz")))) == len(frames) + 1


@pytest.mark.parametrize("seed", [0, 5])
def test_oc20_and_oc22_generators_write_the_examples_bytes(tmp_path, seed):
    """generate_oc20_dataset and generate_oc22_dataset write the files
    of the examples' generators, byte for byte, for two seeds."""
    a = synthetic.generate_oc20_dataset(str(tmp_path / "p20"), num_chunks=2,
                                        frames_per_chunk=6, seed=seed)
    b = oc20_data.generate_oc20_dataset(str(tmp_path / "j20"),
                                        num_chunks=2, frames_per_chunk=6,
                                        seed=seed)
    assert os.path.relpath(a, tmp_path / "p20") == \
        os.path.relpath(b, tmp_path / "j20")
    assert _tree(tmp_path / "p20") == _tree(tmp_path / "j20")
    assert len(_tree(tmp_path / "p20")) == 3
    for data_type in ("train", "val"):
        a = synthetic.generate_oc22_dataset(str(tmp_path / "p22"), data_type,
                                            num_systems=3,
                                            frames_per_system=4, seed=seed)
        b = oc22_data.generate_oc22_dataset(str(tmp_path / "j22"), data_type,
                                            num_systems=3,
                                            frames_per_system=4, seed=seed)
        assert os.path.relpath(a, tmp_path / "p22") == \
            os.path.relpath(b, tmp_path / "j22")
    assert _tree(tmp_path / "p22") == _tree(tmp_path / "j22")


@pytest.mark.parametrize("energy_per_atom", [True, False])
def test_oc20_and_oc22_readers_match_the_examples_bitwise(tmp_path,
                                                          energy_per_atom):
    """load_oc20 / load_oc22 on the generated chunks (periodic cells):
    the examples' samples bitwise, with their limit."""
    synthetic.generate_oc20_dataset(str(tmp_path), num_chunks=2,
                                    frames_per_chunk=5, seed=2)
    synthetic.generate_oc22_dataset(str(tmp_path), "train", num_systems=2,
                                    frames_per_system=4, seed=3)
    kw = dict(radius=5.0, max_neighbours=40,
              energy_per_atom=energy_per_atom)
    got = atomistic.load_oc20(str(tmp_path), **kw)
    assert len(got) == 10 and got[0].edge_shifts is not None
    assert_samples_equal(got, oc20_data.load_oc20(str(tmp_path), **kw))
    assert_samples_equal(atomistic.load_oc20(str(tmp_path), limit=3, **kw),
                         oc20_data.load_oc20(str(tmp_path), limit=3, **kw))
    got = atomistic.load_oc22(str(tmp_path), "train", **kw)
    assert len(got) == 8
    assert_samples_equal(got, oc22_data.load_oc22(str(tmp_path), "train",
                                                  **kw))


def test_frame_to_sample_matches_the_example_bitwise():
    """frame_to_sample on periodic frames, open frames (no cell, and a
    zero cell), and a frame whose forces trip the threshold (None), at
    two radii and neighbour caps; and oc20_slabs, which goes through
    it."""
    rng = np.random.RandomState(11)
    for i, fr in enumerate(_frames(7, n=6) + _frames(8, n=4, cell=False)):
        forces = fr.arrays["forces"] * (60.0 if i == 2 else 1.0)
        for cell in (fr.cell, np.zeros((3, 3), np.float32)):
            for radius, cap in ((3.0, 100), (6.0, 4)):
                args = (fr.z, fr.pos, fr.info["energy"], forces, radius, cap)
                got = atomistic.frame_to_sample(*args, cell=cell)
                want = ex_frame_to_sample(*args, cell=cell)
                assert_samples_equal([got], [want])
                got = atomistic.frame_to_sample(*args, cell=cell,
                                                energy_per_atom=False)
                want = ex_frame_to_sample(*args, cell=cell,
                                          energy_per_atom=False)
                assert_samples_equal([got], [want])
    big = np.full((3, 3), 100.0, np.float32)
    assert atomistic.frame_to_sample(np.ones(3), rng.randn(3, 3), 1.0, big,
                                     5.0, 10) is None
