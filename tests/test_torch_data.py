"""The port's data layer against ``pdgn_tpu.data`` on the same files and the
same random streams: ShapeNetCore (order, items, every scale mode, the
stats cache, several categories and "all"), ModelNetDataset, PartDataset,
every provider augmentation, ``load_h5``, and the loader's batches. The
fixtures mirror tests/test_data.py:16-27 and :155-254."""

import os
import shutil
import threading

import h5py
import numpy as np
import pytest
import torch

import pdgn_tpu.data as jdata
from pdgn_tpu.data import provider as jprov
from pdgn_tpu_torch import data as tdata
from pdgn_tpu_torch.data import provider as tprov
from pdgn_tpu_torch.data.shapenet import SCALE_MODES


def _write_shapenet(path, synsets, n_points=2048, seed=0):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for synsetid, n in synsets:
            grp = f.create_group(synsetid)
            for split, k in (("train", n), ("val", 2), ("test", 4)):
                grp.create_dataset(split, data=rng.randn(
                    k, n_points, 3).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_hdf5(tmp_path_factory):
    """tests/test_data.py's file: chair 10 and airplane 6 train clouds."""
    path = tmp_path_factory.mktemp("data") / "shapenet.hdf5"
    _write_shapenet(path, (("03001627", 10), ("02691156", 6)))
    return str(path)


def _copy(path, tmp_path, name):
    """The file in a directory of its own (its own stats cache)."""
    d = tmp_path / name
    d.mkdir()
    shutil.copy(path, d / os.path.basename(path))
    return str(d / os.path.basename(path))


def _same_items(jd, td, seed):
    assert len(jd) == len(td)
    assert [(it.cate, it.id) for it in jd.items] == \
        [(it.cate, it.id) for it in td.items]
    np.testing.assert_array_equal(jd.full_clouds(), td.full_clouds())
    np.random.seed(seed)
    want = [jd[i] for i in range(len(jd))]
    np.random.seed(seed)
    got = [td[i] for i in range(len(td))]
    for w, g in zip(want, got):
        for r in range(4):
            assert g[r].dtype == w[r].dtype
            np.testing.assert_array_equal(g[r], w[r])
        assert g[4] == w[4]


@pytest.mark.parametrize("mode", SCALE_MODES)
def test_shapenet_items_and_stats_match_jax(tiny_hdf5, tmp_path, mode):
    """Order (stable sort by in-split index, then Random(2020)), the
    normalised clouds and the items' draws under one numpy seed are equal;
    the stats file each package writes holds the same mean and std."""
    jpath = _copy(tiny_hdf5, tmp_path, "jax")
    tpath = _copy(tiny_hdf5, tmp_path, "port")
    for split in ("train", "test"):
        jd = jdata.ShapeNetCore(jpath, "chair", split, mode)
        td = tdata.ShapeNetCore(tpath, "chair", split, mode)
        _same_items(jd, td, seed=11)
        assert td.stats["std"] == jd.stats["std"]
    name = "shapenet_stats/stats_03001627.npz"
    zj = np.load(os.path.join(os.path.dirname(jpath), name))
    zt = np.load(os.path.join(os.path.dirname(tpath), name))
    np.testing.assert_array_equal(zt["mean"], zj["mean"])
    assert zt["std"] == zj["std"] and zt["std"].dtype == zj["std"].dtype


def test_shapenet_seeded_draws_and_cached_stats(tiny_hdf5, tmp_path):
    """``seed=`` draws from a RandomState of its own, and a second dataset
    reads the cached stats instead of the file."""
    path = _copy(tiny_hdf5, tmp_path, "seeded")
    jd = jdata.ShapeNetCore(path, "airplane", "val", "global_unit", seed=4)
    td = tdata.ShapeNetCore(path, "airplane", "val", "global_unit", seed=4)
    for i in range(len(jd)):
        for r in range(3):
            np.testing.assert_array_equal(td[i][r], jd[i][r])
    assert td.stats["std"] == jd.stats["std"]


def test_shapenet_several_categories_and_all(tiny_hdf5, tmp_path):
    jd = jdata.ShapeNetCore(tiny_hdf5, ["chair", "airplane"], "train",
                            "shape_unit")
    td = tdata.ShapeNetCore(tiny_hdf5, ["airplane", "chair"], "train",
                            "shape_unit")
    assert len(td) == 16 and {it.cate for it in td.items} == {"chair",
                                                              "airplane"}
    _same_items(jd, td, seed=3)
    # "all" needs every synset in the file; a file with all 55 serves it
    full = tmp_path / "all" / "shapenet.hdf5"
    full.parent.mkdir()
    _write_shapenet(full, [(s, 2) for s in sorted(tdata.synsetid_to_cate)],
                    n_points=32)
    jd = jdata.ShapeNetCore(str(full), "all", "val", "shape_bbox")
    td = tdata.ShapeNetCore(str(full), ["all"], "val", "shape_bbox")
    assert len(td) == 110
    _same_items(jd, td, seed=5)
    assert os.path.isfile(full.parent / "shapenet_stats" / "stats_all.npz")


def test_shapenet_refusals_match_jax(tiny_hdf5):
    for cls in (jdata.ShapeNetCore, tdata.ShapeNetCore):
        with pytest.raises(TypeError):     # choice None: list(None)
            cls(tiny_hdf5, None, "train", "shape_unit")
        with pytest.raises(KeyError):      # "all" on a 2-synset file
            cls(tiny_hdf5, "all", "train", "shape_unit")
        with pytest.raises(AssertionError):
            cls(tiny_hdf5, "chair", "train", "unit_ball")


@pytest.fixture(scope="module")
def modelnet_root(tmp_path_factory):
    """tests/test_data.py's miniature modelnet40_normal_resampled."""
    root = tmp_path_factory.mktemp("mn")
    d = root / "modelnet40_normal_resampled"
    d.mkdir()
    rng = np.random.RandomState(0)
    names = ["chair", "table"]
    for prefix in ("modelnet10", "modelnet40"):
        (d / f"{prefix}_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for name in names:
        (d / name).mkdir()
        for i in range(3):
            sid = f"{name}_{i:04d}"
            ids.append(sid)
            pts = rng.randn(2100, 6).astype(np.float32)
            np.savetxt(d / name / f"{sid}.txt", pts, delimiter=",")
    for prefix in ("modelnet10", "modelnet40"):
        (d / f"{prefix}_train.txt").write_text("\n".join(ids) + "\n")
        (d / f"{prefix}_test.txt").write_text("\n".join(ids[:2]) + "\n")
    return str(root) + "/"


@pytest.mark.parametrize("normal_channel", [False, True])
def test_modelnet_matches_jax(modelnet_root, normal_channel):
    kw = dict(root=modelnet_root, split="train", modelnet10=True,
              batch_size=4, normal_channel=normal_channel,
              normalize=not normal_channel)
    np.random.seed(8)
    jd = jdata.ModelNetDataset(**kw)
    np.random.seed(8)
    td = tdata.ModelNetDataset(**kw)
    np.testing.assert_array_equal(td.idxs, jd.idxs)
    for i in range(len(jd)):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td.full_clouds(), jd.full_clouds())
    assert td.num_channel() == jd.num_channel()
    jr, tr = np.random.RandomState(2), np.random.RandomState(2)
    ja = jdata.ModelNetDataset(**kw, shuffle=True, rng=jr)
    ta = tdata.ModelNetDataset(**kw, shuffle=True, rng=tr)
    while ja.has_next_batch():
        assert ta.has_next_batch()
        (jb, jl), (tb, tl) = ja.next_batch(augment=True), \
            ta.next_batch(augment=True)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
    assert not ta.has_next_batch()
    ja.reset()
    ta.reset()
    np.testing.assert_array_equal(ta.idxs, ja.idxs)
    assert ta.batch_idx == 0
    chairs = tdata.ModelNetDataset(root=modelnet_root, split="test",
                                   class_choice="chair")
    assert len(chairs) == 2 and not chairs.shuffle


@pytest.fixture(scope="module")
def partdata_root(tmp_path_factory):
    """tests/test_data.py's shapenet-part layout (2500 points: sampled
    without replacement; 500: with)."""
    root = tmp_path_factory.mktemp("part")
    rng = np.random.RandomState(0)
    (root / "synsetoffset2category.txt").write_text(
        "Chair\t03001627\nTable\t04379243\n")
    for synset in ("03001627", "04379243"):
        (root / synset / "points").mkdir(parents=True)
        (root / synset / "points_label").mkdir(parents=True)
        for i in range(3):
            n = 2500 if i == 0 else 500
            np.savetxt(root / synset / "points" / f"{i}.pts",
                       rng.randn(n, 3).astype(np.float32))
            np.savetxt(root / synset / "points_label" / f"{i}.seg",
                       rng.randint(1, 5, n))
    return str(root)


@pytest.mark.parametrize("train,classification",
                         [(True, False), (False, True), (True, True)])
def test_partdataset_matches_jax(partdata_root, train, classification):
    kw = dict(root=partdata_root, batch_size=2, train=train,
              classification=classification)
    jd, td = jdata.PartDataset(**kw), tdata.PartDataset(**kw)
    assert td.datapath == jd.datapath and td.classes == jd.classes
    assert td.num_seg_classes == jd.num_seg_classes
    assert len(td) == (4 if train else 2)
    for i in range(len(jd)):
        np.random.seed(i)
        want = jd[i]
        np.random.seed(i)
        got = td[i]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


AUGMENTATIONS = [
    ("shuffle_points", lambda m, x, r: m.shuffle_points(x, rng=r)),
    ("rotate_point_cloud", lambda m, x, r: m.rotate_point_cloud(x, rng=r)),
    ("rotate_point_cloud_z",
     lambda m, x, r: m.rotate_point_cloud_z(x, rng=r)),
    ("rotate_point_cloud_by_angle",
     lambda m, x, r: m.rotate_point_cloud_by_angle(x, 0.7)),
    ("rotate_perturbation_point_cloud",
     lambda m, x, r: m.rotate_perturbation_point_cloud(x, rng=r)),
    ("rotate_point_cloud_with_normal",
     lambda m, x, r: m.rotate_point_cloud_with_normal(x, rng=r)),
    ("rotate_perturbation_point_cloud_with_normal",
     lambda m, x, r: m.rotate_perturbation_point_cloud_with_normal(
         x, rng=r)),
    ("jitter_point_cloud", lambda m, x, r: m.jitter_point_cloud(x, rng=r)),
    ("shift_point_cloud", lambda m, x, r: m.shift_point_cloud(x, rng=r)),
    ("random_scale_point_cloud",
     lambda m, x, r: m.random_scale_point_cloud(x, rng=r)),
    ("random_point_dropout",
     lambda m, x, r: m.random_point_dropout(x, rng=r)),
    ("shuffle_data", lambda m, x, r: m.shuffle_data(
        x, np.arange(len(x)), rng=r)),
]


@pytest.mark.parametrize("name,fn", AUGMENTATIONS,
                         ids=[a[0] for a in AUGMENTATIONS])
@pytest.mark.parametrize("stream", ["rng", "global"])
def test_augmentations_match_jax(name, fn, stream):
    """Each augmentation on the same batch and the same draws (one
    RandomState each, or numpy's global stream seeded alike)."""
    channels = 6 if name.endswith("with_normal") else 3
    x = np.random.RandomState(1).randn(3, 50, channels).astype(np.float32)

    def run(mod):
        if stream == "rng":
            return fn(mod, x.copy(), np.random.RandomState(5))
        np.random.seed(5)
        return fn(mod, x.copy(), None)

    want, got = run(jprov), run(tprov)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_h5_and_file_lists_match_jax(tmp_path):
    """ModelNet's h5 layout (float32 data, uint8 labels)."""
    rng = np.random.RandomState(0)
    path = tmp_path / "ply_data_train0.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=rng.randn(5, 2048, 3).astype(
            np.float32))
        f.create_dataset("label", data=rng.randint(0, 40, (5, 1)).astype(
            np.uint8))
    (jx, jl), (tx, tl) = jprov.load_h5(str(path)), tprov.loadDataFile(
        str(path))
    assert tx.dtype == jx.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tl, jl)
    (tmp_path / "files.txt").write_text(f"{path}\n{path}\n")
    assert tprov.getDataFiles(str(tmp_path / "files.txt")) == \
        jprov.getDataFiles(str(tmp_path / "files.txt"))


@pytest.mark.parametrize("seed", [None, 7])
def test_train_loader_batches_match_jax(tiny_hdf5, seed):
    """``train_loader``'s epoch against ``pdgn_tpu.data.train_loader``'s
    from the same numpy state: the same shuffle, the same draws, CPU
    tensors; the trailing partial batch dropped."""
    jd = jdata.ShapeNetCore(tiny_hdf5, ["chair", "airplane"], "train",
                            "shape_unit")
    td = tdata.ShapeNetCore(tiny_hdf5, ["chair", "airplane"], "train",
                            "shape_unit")
    np.random.seed(21)
    want = list(jdata.train_loader(jd, 5, seed=seed))
    np.random.seed(21)
    got = list(tdata.train_loader(td, 5, seed=seed, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for r in range(4):
            assert isinstance(g[r], torch.Tensor) and g[r].device.type == \
                "cpu"
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w[r]))
        assert g[4] == w[4]


def test_loader_defaults_to_the_card(monkeypatch):
    """With no device given, the loaders ask for the card, as every entry
    point does: where none is visible they raise at the call, before a
    producer thread starts or a batch is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(threading.enumerate())
    state = np.random.get_state()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.prefetch_to_device(iter([(np.zeros(2, np.float32),)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.train_loader(tdata.SyntheticShapes(4, 8, seed=0), 2)
    assert set(threading.enumerate()) == before
    after = np.random.get_state()
    assert state[0] == after[0] and np.array_equal(state[1], after[1])


def test_loader_raises_the_producers_error():
    def batches():
        for i in range(2):
            yield (np.full((2, 3), i, np.float32), "x")
        raise ValueError("bad record")

    got = []
    with pytest.raises(ValueError, match="bad record"):
        for b in tdata.prefetch_to_device(batches(), size=1, device="cpu"):
            got.append(b)
    assert [float(b[0][0, 0]) for b in got] == [0.0, 1.0]


def test_abandoned_epoch_releases_the_producer():
    """A consumer that leaves an endless epoch: the producer, parked on a
    full queue, stops and its thread ends."""
    before = set(threading.enumerate())

    def endless():
        i = 0
        while True:
            yield (np.full((1,), i, np.float32),)
            i += 1

    loader = tdata.prefetch_to_device(endless(), size=2, device="cpu")
    first = next(loader)
    assert float(first[0][0]) == 0.0
    started = set(threading.enumerate()) - before
    assert len(started) == 1
    loader.close()
    (thread,) = started
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_splits_and_iterators_match_jax():
    ds = list(range(20))
    assert tdata.split_sizes(100, 0.8, 0.1) == jdata.split_sizes(100, 0.8,
                                                                 0.1)
    want = jdata.get_train_val_test_datasets(ds, 0.7, 0.2, seed=0)
    got = tdata.get_train_val_test_datasets(ds, 0.7, 0.2, seed=0)
    for g, w in zip(got, want):
        assert [g[i] for i in range(len(g))] == [w[i] for i in range(len(w))]
    with pytest.raises(ValueError):
        tdata.random_split(ds, [3, 4])
