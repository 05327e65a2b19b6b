"""The port's HDF5 reader (``pdgn_tpu_torch.data.h5``) against h5py on files
h5py writes by default, its refusals, and the numpy writer of
``torch_h5_fixture`` read back by h5py and by the reader."""

import h5py
import numpy as np
import pytest

import torch_h5_fixture as fx
from pdgn_tpu_torch.data import h5


def _same_tree(ref, got):
    """Every group and dataset of an h5py file equal in the reader:
    names, dtypes, shapes and values."""
    assert sorted(ref.keys()) == got.keys()
    for name in ref:
        if isinstance(ref[name], h5py.Group):
            _same_tree(ref[name], got[name])
            continue
        want, have = ref[name][()], got[name][()]
        assert have.dtype == want.dtype, name
        assert have.shape == want.shape, name
        np.testing.assert_array_equal(have, want, err_msg=name)


def _check(path):
    with h5py.File(path, "r") as ref, h5.File(path) as got:
        _same_tree(ref, got)


DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8]


@pytest.mark.parametrize("dtype", DTYPES)
def test_default_layout_every_dtype(tmp_path, dtype):
    rng = np.random.RandomState(0)
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("03001627")
        g.create_dataset("train", data=(rng.randn(4, 7, 3) * 50).astype(dtype))
        g.create_dataset("one_d", data=(rng.randn(11) * 50).astype(dtype))
        g.create_dataset("scalar", data=dtype(7))
    _check(path)
    with h5.File(path) as f:
        ds = f["03001627/train"]
        assert ds.shape == (4, 7, 3) and ds.dtype == np.dtype(dtype)
        assert ds.chunks is None and ds.compression is None
        assert len(ds) == 4 and len(ds[:2]) == 2
        assert f["03001627"]["scalar"][()] == 7


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
@pytest.mark.parametrize("shuffle", [True, False])
def test_chunked_gzip_with_ragged_last_chunk(tmp_path, dtype, shuffle):
    """13 clouds in chunks of 5 (the last holds 3) and a 7-point axis in
    chunks of 4: edge chunks on two axes, through deflate with and
    without shuffle."""
    rng = np.random.RandomState(1)
    data = (rng.randn(13, 7, 3) * 10).astype(dtype)
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(5, 4, 3),
                         compression="gzip", shuffle=shuffle)
        f.create_dataset("plain_chunks", data=data, chunks=(2, 7, 3))
    _check(path)
    with h5.File(path) as f:
        assert f["x"].chunks == (5, 4, 3) and f["x"].compression == "gzip"
        assert f["x"].shuffle == shuffle
        np.testing.assert_array_equal(f["x"][...], data)


def test_unwritten_storage_reads_as_the_fill_value(tmp_path):
    path = tmp_path / "e.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("late", shape=(3, 2), dtype=np.float32)
        f.create_dataset("chunked", shape=(5, 2), dtype=np.float32,
                         chunks=(2, 2), fillvalue=2.5)
        f["chunked"][0:2] = 1.0       # one chunk written, two not
    _check(path)


@pytest.mark.parametrize("n_groups,levels", [(55, 0), (300, 1)])
def test_root_with_many_groups(tmp_path, n_groups, levels):
    """55 synset-like groups fill several symbol nodes under one B-tree
    node; 300 (more than one node's 32 symbol nodes of 8 can hold) need a
    two-level B-tree; a chunked dataset of 150 chunks needs a two-level
    chunk B-tree."""
    rng = np.random.RandomState(2)
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        for i in range(n_groups):
            g = f.create_group(f"{rng.randint(10 ** 7, 10 ** 8):08d}_{i}")
            g.create_dataset("train", data=rng.randn(2, 3).astype(np.float32))
        f.create_dataset("many_chunks", data=rng.randn(300, 7),
                         chunks=(2, 7))
    _check(path)
    with h5.File(path) as f:
        assert len(f) == n_groups + 1
        root = h5._Messages(f._r, int.from_bytes(f._r.read(64, 8), "little"))
        btree = int.from_bytes(root.get(h5.MSG_SYMBOL_TABLE)[:8], "little")
        level, used, _ = f._btree_node(btree, 0, 8)
        assert level == levels and (levels or used > 1)
        chunk_root = f["many_chunks"]._addr
        assert f._btree_node(chunk_root, 1, 8 + 8 * 3)[0] >= 1


def test_files_outside_the_subset_are_refused(tmp_path):
    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(h5.H5FormatError, match="superblock version"):
        h5.File(tmp_path / "latest.h5")
    with h5py.File(tmp_path / "lzf.h5", "w") as f:
        f.create_dataset("x", data=np.zeros((4, 4)), chunks=(2, 2),
                         compression="lzf")
        f.create_dataset("s", data=np.array([b"ab", b"cd"]))
        f.create_dataset("f2", data=np.zeros(3, np.float16))
        f.create_dataset("be", data=np.zeros(3, ">f4"))
    with h5.File(tmp_path / "lzf.h5") as f:
        with pytest.raises(h5.H5FormatError, match="filter lzf"):
            f["x"]
        with pytest.raises(h5.H5FormatError, match="string"):
            f["s"]
        with pytest.raises(h5.H5FormatError, match="floating-point 2"):
            f["f2"]
        with pytest.raises(h5.H5FormatError, match="big-endian"):
            f["be"]
        with pytest.raises(KeyError):
            f["missing"]
    (tmp_path / "no.h5").write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(h5.H5FormatError, match="no HDF5 signature"):
        h5.File(tmp_path / "no.h5")


def test_writer_is_read_back_by_h5py_and_the_reader(tmp_path):
    """The smoke writer's shapenet15k layout (chair train contiguous, test
    chunked through shuffle and deflate with a ragged last chunk) and a
    tree of every dtype: h5py and the reader return exactly what was
    written."""
    path = tmp_path / "shapenet.hdf5"
    splits = {fx.CHAIR: {"train": 7, "val": 2, "test": 12},
              fx.AIRPLANE: {"train": 3, "val": 1, "test": 2}}
    clouds = fx.write_shapenet(str(path), 5, n_points=64, splits=splits)
    rng = np.random.RandomState(3)
    tree = {"g": {f"n{i:02d}": rng.randn(2, 3).astype(np.float32)
                  for i in range(20)}}
    tree.update({np.dtype(d).name: (rng.randn(5, 3) * 50).astype(d)
                 for d in DTYPES})
    fx.write(str(tmp_path / "w.h5"), tree, {"float64": (2, 2)})
    for p, want in ((path, clouds), (tmp_path / "w.h5", tree)):
        with h5py.File(p, "r") as ref, h5.File(p) as got:
            _same_tree(ref, got)

            def walk(node, w):
                for k, v in w.items():
                    if isinstance(v, dict):
                        walk(node[k], v)
                    else:
                        assert node[k][()].dtype == v.dtype
                        np.testing.assert_array_equal(node[k][()], v)
            walk(ref, want)
    with h5py.File(path, "r") as ref:
        test = ref[fx.CHAIR]["test"]
        assert test.chunks == (5, 64, 3) and test.compression == "gzip"
        assert test.shuffle and ref[fx.CHAIR]["train"].chunks is None
