"""The port's CLI train phase resuming from the ``.pth`` bundles of an
earlier run on the CPU: the saved epoch and Adam's state go on."""

import torch

from torch_entry_util import _train_args
from torch_port_util import one_torch_thread  # noqa: F401

from pdgn_tpu_torch import cli


def test_cli_train_resumes_from_pretrained_bundles(tmp_path, capsys):
    cli.main(_train_args(tmp_path, "--device", "cpu"))
    bundles = tmp_path / "ckpt" / "m" / "PDGNet_v2"
    first = torch.load(bundles / "1_full_G.pth", weights_only=True)
    capsys.readouterr()
    cli.main(_train_args(tmp_path, "--device", "cpu", "--max_epoch", "2",
                         "--pretrain_model_G", "1_full_G.pth",
                         "--pretrain_model_D", "1_full_D.pth"))
    out = capsys.readouterr().out
    assert "Load SUCCESS" in out
    # resumes at the saved epoch and runs through max_epoch: epochs 1 and 2
    assert out.count("Epoch: [ 1]") == 2 and out.count("Epoch: [ 2]") == 2
    second = torch.load(bundles / "2_full_G.pth", weights_only=True)
    assert second["G_epoch"] == 2
    # the Adam state went on from the loaded one: 2 + 4 steps
    steps = {int(v["step"]) for v in second["G_optimizer"]["state"].values()}
    assert steps == {6}
    assert not all(torch.equal(first["G_model"][k], second["G_model"][k])
                   for k in first["G_model"])
