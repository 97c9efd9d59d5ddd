"""The port's training CLIs (simple_sfod_tpu_torch/tools/train_net.py and
train_net_mt.py) on the CPU, on configs/synthetic_tiny.yaml with
--synthetic: training writes metrics and model_final.pth and --resume
continues it; --eval-only refines the BatchNorm statistics (train_net_mt
from reset ones: AdaBN), evaluates and saves adabn.pth; without a GPU and
without --device cpu the CLI raises, and multi-device settings that cannot
run raise rather than being ignored (tests/test_torch_parallel.py runs the
ones that can)."""

import json
import os
import subprocess
import sys

import numpy as np
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


def test_adabn_batches_flag_cuts_the_refinement(tmp_path, capsys):
    """--adabn-batches N refines over N batches (the default stays
    ADABN_MAX_BATCHES, the reference's 1400)."""
    assert train_net.default_argument_parser().parse_args([]).adabn_batches is None and base.ADABN_MAX_BATCHES == 1400
    train_net.main(args(tmp_path, "--eval-only", "--adabn-batches", "3"), eval_mode="adabn")
    assert "[adabn] BatchNorm statistics refined over 3 batches" in capsys.readouterr().out


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
def test_multi_device_settings_raise(tmp_path, monkeypatch, extra):
    """The multi-device settings that cannot run here raise before a step
    rather than being ignored: more local processes than GPUs, several
    machines without --dist-url, a mesh of more ranks than processes, and
    spatial sharding without a model axis (the JAX package's ValueError)."""
    error, match = {
        "--num-gpus": (ValueError, "--num-gpus 2 exceeds the 1 visible CUDA device"),
        "--num-machines": (ValueError, "--num-machines 2 needs --dist-url"),
        "TPU.MESH_DATA": (ValueError, "data 2 x model 1 layout needs 2 processes"),
        "TPU.MESH_MODEL": (ValueError, "data 1 x model 2 layout needs 2 processes"),
        "TPU.SPATIAL_SHARD": (ValueError, r"TPU.SPATIAL_SHARD=True requires TPU.MESH_MODEL > 1"),
    }[extra[0]]
    device = "cpu"
    if extra[0] == "--num-gpus":  # one visible GPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        device = "cuda"
    with pytest.raises(error, match=match):
        train_net.main(args(tmp_path, *extra, device=device))


# the three ResNet-101 C4 workloads, cut to the CPU: a 64x128 canvas, a
# narrow box head, 2 steps or 2 AdaBN batches; full depth, the YAMLs' norms,
# FREEZE_AT and bfloat16
R101_CLI = {
    "adabn": ("r_101_c4_cs_foggy_adabn.yaml", "train_net_mt", ["--eval-only"]),
    "sfat": ("r101_c4_cs_foggy_adaptive_teacher_source_free.yaml", "train_net_mt", []),
    "source_frozen": ("r_101_c4_cs_source_frozen.yaml", "train_net", []),
}
R101_CUTS = ["TPU.CANVAS", "(64, 128)", "INPUT.MIN_SIZE_TRAIN", "(60,)", "INPUT.MIN_SIZE_TEST", "60",
             "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "0",
             "TEST.EVAL_PERIOD", "0", "VIS_PERIOD", "0", "SOLVER.WARMUP_ITERS", "0"]


@pytest.mark.parametrize("workload", list(R101_CLI))
def test_r101_workloads_through_the_clis(tmp_path, monkeypatch, workload):
    """configs/r_101_c4_cs_foggy_adabn.yaml through train_net_mt --eval-only
    (AdaBN: live BN statistics reset and refined, both TEST sets evaluated),
    r101_c4_cs_foggy_adaptive_teacher_source_free.yaml through train_net_mt
    (SFAT steps) and r_101_c4_cs_source_frozen.yaml through train_net (base
    steps at IMS_PER_BATCH 4, FrozenBN): the stem and res2 parameters are
    bit-identical after training, FrozenBN buffers too, losses finite."""
    yaml, cli, flags = R101_CLI[workload]
    monkeypatch.setattr(base, "ADABN_MAX_BATCHES", 2)
    argv = ["--config-file", os.path.join(ROOT, "configs", yaml), "--synthetic", "--device", "cpu", *flags,
            *R101_CUTS, "OUTPUT_DIR", str(tmp_path)]
    built = []
    build = base.BaseTrainer.__init__

    def keep(self, *a, **kw):
        build(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(base.BaseTrainer, "__init__", keep)
    resets = []
    reset = base.BaseTrainer.reset_bn_stats
    monkeypatch.setattr(base.BaseTrainer, "reset_bn_stats", lambda self: resets.append(1) or reset(self))
    # train_net_mt is train_net whose --eval-only runs AdaBN
    results = train_net.main(train_net.default_argument_parser().parse_args(argv),
                             eval_mode="adabn" if cli == "train_net_mt" else "test")
    tr, = built
    assert tr.det_cfg.backbone == "resnet101" and tr.det_cfg.dtype == torch.bfloat16
    if workload == "adabn":
        assert resets == [1]
        assert set(results) == {"cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02"}
        bns = tr._batchnorms()
        assert len(bns) == 94 and all(torch.isfinite(m.running_var).all() and not torch.all(m.running_var == 1.0)
                                      for m in bns)
        assert os.path.exists(tmp_path / "adabn.pth")
        return
    data = torch.load(tmp_path / "model_final.pth", weights_only=True)
    assert data["iteration"] == 2
    with open(tmp_path / "metrics.json") as f:
        line = json.loads(f.read().strip().splitlines()[-1])
    assert line["iteration"] == 1 and all(np.isfinite(v) for k, v in line.items() if k.startswith("loss"))
    start = type(tr)(tr.cfg, device="cpu").state.model.state_dict()  # the same seeded weights
    got = tr.state.model.state_dict()
    frozen = [k for k in got if k.startswith(("backbone.stem.", "backbone.res2."))
              and not (workload == "sfat" and k.endswith(("running_mean", "running_var", "num_batches_tracked")))]
    assert frozen and all(torch.equal(got[k], start[k]) for k in frozen)
    if workload == "source_frozen":
        buffers = [k for k in got if ".norm." in k]
        assert len(buffers) == 5 * 94 and all(torch.equal(got[k], start[k]) for k in buffers)
    assert not all(torch.equal(got[k], start[k]) for k in got if k.startswith("backbone.res4."))
