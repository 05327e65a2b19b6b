"""Checks of the port's entry points that run no phase: the dtype flags'
values, the JAX CLI's flags all accepted, import hygiene, no switch that
routes around a kernel, and the kernel sources' header notes."""

import os
import re
import subprocess
import sys

import pytest

from torch_entry_util import PKG, ROOT, _cli_args

from pdgn_tpu_torch import cli


@pytest.mark.parametrize("flag", ["--compute_dtype", "--d_compute_dtype"])
def test_cli_refuses_bf16_compute(tmp_path, flag, capsys):
    """Both dtype flags take float32 and, bf16 training being ported,
    bfloat16 for ``--phase train``; a dtype with no kernel instance
    (float16) exits 2. The name is kept from when the port refused
    bfloat16 training."""
    assert cli.parse_args(_cli_args(tmp_path, flag, "float32"))
    args = cli.parse_args(_cli_args(tmp_path, "--phase", "train", "--device",
                                    "cpu", flag, "bfloat16"))
    assert getattr(args, flag[2:]) == "bfloat16"
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(_cli_args(tmp_path, "--phase", "train", "--device",
                                 "cpu", flag, "float16"))
    assert exc.value.code == 2


def test_cli_accepts_every_flag_of_the_jax_cli():
    flag = re.compile(r"add_argument\(\s*'(--\w+)'")
    jax_flags = set(flag.findall((ROOT / "pdgn_tpu" / "cli.py").read_text()))
    ours = set(flag.findall((PKG / "cli.py").read_text()))
    assert len(jax_flags) > 30 and jax_flags <= ours, jax_flags - ours


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX, flax, the
    JAX package, h5py or msgpack (the card's machine has neither)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pdgn_tpu', 'h5py', 'msgpack')]\n"
            "print(len(bad), bad[:5])\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 20


def test_no_environment_switch_on_the_kernel_path():
    """No environment variable routes around a kernel: the package reads
    no ``os.environ`` / ``os.getenv`` at all."""
    pattern = re.compile(r"os\.environ|getenv|PDGN_DISABLE")
    hits = [str(p) for p in PKG.rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


def test_kernel_sources_carry_their_header_note():
    for src in ("edge_head.cu", "slot_stats.cu", "bilateral_tail.cu",
                "edge_head_bwd.cu", "bilateral_tail_bwd.cu",
                "local_stats.cu", "emd_cd.cu", "knn.cu"):
        text = (PKG / "csrc" / src).read_text()
        head = text[:3000]
        assert "Replaces the TPU kernel" in head and "pdgn_tpu/ops/pallas/" in head
        assert "bounds it on the H100" in head
        assert re.search(r"The (simple )?design", head)
