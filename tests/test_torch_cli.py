"""The port's training CLIs (simple_sfod_tpu_torch/tools/train_net.py and
train_net_mt.py) on the CPU, on configs/synthetic_tiny.yaml with
--synthetic: training writes metrics and model_final.pth and --resume
continues it; --eval-only refines the BatchNorm statistics (train_net_mt
from reset ones: AdaBN), evaluates and saves adabn.pth; without a GPU and
without --device cpu the CLI raises, and multi-device settings raise
rather than being ignored."""

import json
import os
import subprocess
import sys

import pytest
import torch

from simple_sfod_tpu_torch.engine.trainers import base
from simple_sfod_tpu_torch.tools import train_net
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: removes each test's directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "synthetic_tiny.yaml")


def args(out, *extra, device="cpu"):
    argv = ["--config-file", TINY, "--synthetic"] + (["--device", device] if device else []) + list(extra)
    return train_net.default_argument_parser().parse_args(argv + ["OUTPUT_DIR", str(out)])


def test_train_net_trains_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "simple_sfod_tpu_torch.tools.train_net", "--config-file", TINY, "--synthetic",
           "--device", "cpu", "OUTPUT_DIR", str(tmp_path), "SOLVER.CHECKPOINT_PERIOD", "3"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("[launches] ")
    assert json.loads(lines[-1][len("[launches] "):]) == {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}
    assert any(line.startswith("iter 4/5") for line in lines)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pth")) == ["model_0000002.pth", "model_final.pth"]
    with open(tmp_path / "metrics.json") as f:
        assert [json.loads(line)["iteration"] for line in f] == [4]

    train_net.main(args(tmp_path, "--resume", "SOLVER.MAX_ITER", "7"))
    data = torch.load(tmp_path / "model_final.pth", weights_only=True)
    assert data["iteration"] == 7 and data["optimizer"]["count"] == 7
    with open(tmp_path / "metrics.json") as f:
        assert [json.loads(line)["iteration"] for line in f] == [4, 6]


@pytest.mark.parametrize("eval_mode", ["test", "adabn"], ids=["train_net", "train_net_mt"])
def test_eval_only(tmp_path, monkeypatch, eval_mode):
    """--eval-only: train_net refines from the loaded statistics
    (test_refinement), train_net_mt resets them first (adabn_refinement);
    2 batches instead of 1400."""
    monkeypatch.setattr(base, "ADABN_MAX_BATCHES", 2)
    resets = []
    reset = base.BaseTrainer.reset_bn_stats
    monkeypatch.setattr(base.BaseTrainer, "reset_bn_stats", lambda self: resets.append(1) or reset(self))
    results = train_net.main(args(tmp_path, "--eval-only"), eval_mode=eval_mode)
    assert set(results) == {"synthetic_test"} and "AP50" in results["synthetic_test"]
    assert resets == ([1] if eval_mode == "adabn" else [])
    assert os.path.exists(tmp_path / "adabn.pth") and os.path.exists(tmp_path / "eval_results.json")
    with open(tmp_path / "last_checkpoint") as f:
        assert f.read() == "adabn.pth"


def test_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(args(tmp_path, device=None))


@pytest.mark.parametrize(
    "extra",
    [["--num-gpus", "2"], ["--num-machines", "2"], ["TPU.MESH_DATA", "2"], ["TPU.MESH_MODEL", "2"],
     ["TPU.SPATIAL_SHARD", "True"]],
    ids=["num-gpus", "num-machines", "mesh-data", "mesh-model", "spatial-shard"],
)
def test_multi_device_settings_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP item 6.9"):
        train_net.main(args(tmp_path, *extra))
