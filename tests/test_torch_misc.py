"""The port's utilities (``pdgn_tpu_torch.utils.misc`` and the loader's
split helpers): tests/test_utils.py's cases on the port, plus the checkpoint
manager's files read by the JAX package's manager and the port's by
it."""

import argparse
import logging
import os

import numpy as np
import torch

from pdgn_tpu.utils import CheckpointManager as JaxCheckpointManager
from pdgn_tpu_torch.data import (Subset, get_data_iterator,
                                 get_train_val_test_datasets, random_split,
                                 split_sizes)
from pdgn_tpu_torch.utils.misc import (BlackHole, CheckpointManager,
                                       get_logger, get_new_log_dir, int_list,
                                       int_tuple, log_hyperparams, seed_all,
                                       str_list, str_tuple)


def test_blackhole_swallows_everything():
    bh = BlackHole()
    bh.anything = 5
    assert bh.foo.bar(1, 2, x=3) is bh


def test_seed_all_reproducible():
    seed_all(123)
    a, ta = np.random.rand(5), torch.rand(5)
    seed_all(123)
    b, tb = np.random.rand(5), torch.rand(5)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(ta, tb)


def test_get_logger_writes_file(tmp_path):
    logger = get_logger("t", str(tmp_path))
    logger.info("hello world")
    for h in logger.handlers:
        h.flush()
    assert "hello world" in (tmp_path / "log.txt").read_text()
    for h in logging.getLogger("t").handlers:
        h.close()
    logging.getLogger("t").handlers.clear()


def test_get_new_log_dir(tmp_path):
    d = get_new_log_dir(str(tmp_path), postfix="_run", prefix="pdgn_")
    name = os.path.basename(d)
    assert os.path.isdir(d) and name.startswith("pdgn_")
    assert name.endswith("_run")


def test_arg_parsers():
    assert int_tuple("1,2,3") == (1, 2, 3)
    assert str_tuple("a,b") == ("a", "b")
    assert int_list("4,5") == [4, 5]
    assert str_list("x,y") == ["x", "y"]


def test_checkpoint_manager_keeps_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = {"w": np.arange(4, dtype=np.float32)}
    assert mgr.save(state, score=3.0, step=1)
    assert mgr.save({"w": np.ones(4, np.float32)}, score=1.0, step=2)
    # worse than both kept scores -> rejected
    assert not mgr.save(state, score=9.0, step=3)
    # better -> replaces the worst
    assert mgr.save({"w": torch.zeros(4)}, score=0.5, step=4)
    assert len(mgr.ckpts) == 2
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0.500000_4",
                                            "ckpt_1.000000_2"]
    np.testing.assert_array_equal(mgr.load_best()["w"], np.zeros(4))
    np.testing.assert_array_equal(mgr.load_latest()["w"], np.zeros(4))
    # a fresh manager re-scans the directory
    assert len(CheckpointManager(str(tmp_path), max_to_keep=2).ckpts) == 2


def test_checkpoint_manager_files_are_the_jax_packages(tmp_path):
    """Either package's manager reads the other's files."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    CheckpointManager(str(ours)).save(
        {"w": np.arange(3, dtype=np.float32), "n": [1, 2]}, 0.25, step=7)
    got = JaxCheckpointManager(str(ours)).load_best()
    np.testing.assert_array_equal(got["w"], np.arange(3))
    assert got["n"] == {"0": 1, "1": 2}
    JaxCheckpointManager(str(theirs)).save(
        {"w": np.ones((2, 2), np.float32)}, 0.5, step=3)
    mgr = CheckpointManager(str(theirs))
    assert mgr.ckpts == [{"score": 0.5, "file": "ckpt_0.500000_3",
                          "iteration": 3}]
    np.testing.assert_array_equal(mgr.load_latest()["w"], np.ones((2, 2)))


def test_checkpoint_manager_on_an_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.get_best_ckpt_idx() is None
    try:
        mgr.load_best()
    except IOError as e:
        assert "No checkpoints" in str(e)
    else:
        raise AssertionError("load_best on no checkpoints")


def test_split_helpers():
    assert split_sizes(100, 0.8, 0.1) == (80, 10, 10)
    ds = list(range(20))
    tr, va, te = get_train_val_test_datasets(ds, 0.7, 0.2, seed=0)
    assert (len(tr), len(va), len(te)) == (14, 4, 2)
    all_items = sorted([tr[i] for i in range(len(tr))]
                       + [va[i] for i in range(len(va))]
                       + [te[i] for i in range(len(te))])
    assert all_items == ds
    tr2, _, _ = get_train_val_test_datasets(ds, 0.7, 0.2, seed=0)
    assert [tr[i] for i in range(len(tr))] == [tr2[i] for i in range(len(tr2))]


def test_subset_and_random_split():
    ds = list(range(10))
    s = Subset(ds, [3, 1, 4])
    assert len(s) == 3 and s[0] == 3 and s[2] == 4
    a, b = random_split(ds, [6, 4], seed=1)
    assert len(a) == 6 and len(b) == 4


def test_infinite_iterator():
    it = get_data_iterator([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_log_hyperparams_both_writer_styles():
    """Hyperparameters through add_hparams when the writer has it (non-
    strings repr'd), else one text summary."""
    args = argparse.Namespace(batch_size=50, network="PDGNet_v2",
                              choice=None)

    class TextWriter:
        def __init__(self):
            self.texts = []

        def add_text(self, tag, text):
            self.texts.append((tag, text))

    class HParamWriter(TextWriter):
        def add_hparams(self, hparams, metrics):
            self.hparams = hparams

    w = TextWriter()
    log_hyperparams(w, args)
    assert "batch_size: 50" in w.texts[0][1]
    w2 = HParamWriter()
    log_hyperparams(w2, args)
    assert w2.hparams["network"] == "PDGNet_v2"
    assert w2.hparams["choice"] == "None"
