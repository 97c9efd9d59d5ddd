"""Spatial sharding (TPU.SPATIAL_SHARD, simple_sfod_tpu_torch/parallel/
spatial.py) on the CPU with gloo: each image in height bands over the model
ranks, against one process on the whole image and against the JAX
package's spatially sharded mesh.

Ranks are processes spawned by the port's launcher running
tests/torch_parallel_workers.py (no JAX); the JAX side runs here on the
virtual devices of tests/conftest.py. What is held, and how closely:
  band plan     boundaries on multiples of the backbone's band stride, the
                extra units on the first bands, the remainder on the last;
                too few rows raise
  backbones     tiny, VGG16-BN, VGG16, cut ResNet-50 and ResNet-101 C4
                (BN and FrozenBN each), VGG-FPN (BN) and R50-FPN on 2
                ranks, even and uneven bands and heights that no band stride
                divides, in float64, against one process: every returned
                map, the input gradient, every parameter gradient (summed
                over the bands) and every running statistic within 1e-5 of
                the tensor's largest entry (a BN-fed conv bias's gradient,
                exactly 0, of its weight gradient's). In float32 a rounding
                difference can flip a ReLU or a max pool's choice and move
                one gradient entry whole, so float32 steps are held by the
                lockstep bounds instead.
  base steps    data 1 x model 2 and data 2 x model 2 with bands against
                the JAX BaseTrainer on the same spatially sharded mesh
                (test_torch_parallel.py:check_base's bounds)
  SFAT step     VGG16-BN at 64x128 on data 1 x model 2 with bands against
                the JAX SFAT trainer on the spatial 1 x 2 mesh, each of 2
                steps from the JAX state on the JAX draws
                (test_torch_parallel.py:sfat_steps_as_jax's bounds)
  trainers      the WQ family, da, cda, the adaptive teacher and the other
                source-free variants with bands against one process
                (test_torch_parallel.py:check_trainer's bounds)
  eval, AdaBN   with bands against one process: results and detections
                equal, rank 0 alone writes, AdaBN's statistics within 1e-5
  CLI           train_net on 2 processes with bands (steps, test(), a
                checkpoint that loads strictly into one process) and
                train_net_mt --eval-only (AdaBN) on them
  refusal       TPU.SPATIAL_SHARD without a model axis raises ValueError
"""

import json
import os

import pytest
import torch

import torch_parallel_workers as W
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.parallel import spatial
from test_torch_parallel import (CLI, CLI_CUTS, EVAL_OPTS, TRAINERS, base_case, check_base, check_trainer, run_cli,
                                 sfat_steps_as_jax, trainer_job)
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: removes each test's directory)

FPN = {"fpn": True, "fpn_in_features": ("vgg1", "vgg2", "vgg3", "vgg4"),
       "rpn_in_features": ("p2", "p3", "p4", "p5", "p6"), "roi_in_features": ("p2", "p3", "p4", "p5")}
BACKBONES = {  # case: its DetectorConfig fields, the images' shape and a cut ResNet block plan
    "tiny": ({"backbone": "tiny", "in_feature": "tiny1"}, (2, 3, 36, 40), None),  # bands of 20 and 16 rows
    "vgg16_bn": ({"backbone": "vgg16"}, (1, 3, 100, 64), None),  # 64 and 36: 100 is no multiple of 32
    "vgg16": ({"backbone": "vgg16", "vgg_bn": False}, (2, 3, 64, 64), None),  # 32 and 32
    "r50_c4_bn": ({"backbone": "resnet50", "in_feature": "res4"}, (1, 3, 40, 48), (1, 1, 1, 1)),  # 16 and 24
    "r50_c4_frozen": ({"backbone": "resnet50", "in_feature": "res4", "resnet_norm": "FrozenBN"}, (1, 3, 64, 32),
                      (1, 1, 1, 1)),  # 32 and 32
    "r101_c4_bn": ({"backbone": "resnet101", "in_feature": "res4"}, (1, 3, 56, 32), (1, 1, 2, 1)),  # 32 and 24
    "r101_c4_frozen": ({"backbone": "resnet101", "in_feature": "res4", "resnet_norm": "FrozenBN"}, (2, 3, 48, 32),
                       (1, 2, 2, 1)),  # 32 and 16
    "vgg_fpn_bn": ({**FPN, "fpn_norm": "BN"}, (1, 3, 192, 64), None),  # 128 and 64
    "r50_fpn": ({**FPN, "backbone": "resnet50", "fpn_in_features": ("res2", "res3", "res4", "res5")},
                (1, 3, 136, 64), (1, 1, 1, 1)),  # 64 and 72
}
SPATIAL = ["TPU.MESH_MODEL", "2", "TPU.SPATIAL_SHARD", "True"]


def test_band_plan():
    assert spatial.band_plan(608, 32, 2) == [(0, 320), (320, 608)]  # 19 units: VGG16 at 608 rows
    assert spatial.band_plan(608, 16, 2) == [(0, 304), (304, 608)]
    assert spatial.band_plan(600, 64, 4) == [(0, 192), (192, 320), (320, 448), (448, 600)]
    assert spatial.band_plan(100, 32, 3) == [(0, 32), (32, 64), (64, 100)]
    with pytest.raises(ValueError, match="too few for a model width of 3"):
        spatial.band_plan(95, 32, 3)


@pytest.fixture(scope="module")
def banded(tmp_path_factory):
    """Every backbone case on 2 ranks, in one spawn: {case: (errs, plan)}."""
    cases = {name: {"det": det, "shape": shape, "blocks": blocks} for name, (det, shape, blocks) in BACKBONES.items()}
    path = tmp_path_factory.mktemp("bands") / "jobs.pt"
    ranks = W.spawn(path, [("b", dict(job="bands", cases=cases))])
    return [r["b"] for r in ranks]


@pytest.mark.parametrize("case", list(BACKBONES))
def test_banded_backbone_as_one_process(banded, case):
    _, shape, _ = BACKBONES[case]
    for r in banded:
        errs = r[case]["errs"]
        assert {k.split(".")[0] for k in errs} >= {"map", "grad"}, errs
        assert "grad.input" in errs and (case == "vgg16") != any(k.startswith("stat.") for k in errs)
        bad = {k: v["max"] for k, v in errs.items() if not v["max"] <= 1e-5}
        assert not bad, (case, bad)
        (a0, b0), (a1, b1) = r[case]["plan"]
        assert a0 == 0 and b0 == a1 and b1 == shape[2]
    if case not in ("vgg16", "r50_c4_frozen"):
        (a0, b0), (a1, b1) = banded[0][case]["plan"]
        assert b0 - a0 != b1 - a1  # uneven bands


@pytest.mark.parametrize("data", [1, 2])
def test_banded_base_step_as_the_jax_spatial_mesh(tmp_path, data):
    """Data x model 2 ranks with bands (tiny backbone, 64x128 canvases: 16
    units of 4 rows) against the JAX BaseTrainer on the same mesh with
    TPU.SPATIAL_SHARD, 2 free steps on the JAX draws."""
    job, jax_out, want, init = base_case(tmp_path, data, 2, spatial=True)
    ranks = W.spawn(tmp_path / "jobs.pt", [("sp", job)], world=2 * data)
    check_base(ranks, "sp", jax_out, want, init)


def test_banded_sfat_step_as_the_jax_spatial_mesh(tmp_path):
    """The main path (VGG16-BN, strong view, adaptive threshold) with bands
    of 32 rows on data 1 x model 2 against the JAX SFAT trainer on the
    spatial 1 x 2 mesh."""
    sfat_steps_as_jax(tmp_path, {"MESH_DATA": 1, "MESH_MODEL": 2, "SPATIAL_SHARD": True}, {"data": 1, "model": 2})


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Every TRAINERS case with bands on 2 ranks, in one spawn, and on one
    process: {case: (ranks' steps, one process's steps, weights)}."""
    jobs, ones, weights = [], [], {}
    for name in TRAINERS:
        job, weights[name] = trainer_job(tmp_path_factory.mktemp(name), name, SPATIAL)
        jobs.append((name, job))
        one, _ = trainer_job(tmp_path_factory.mktemp(f"{name}_one"), name)
        ones.append((name, one))
    ranks = W.spawn(tmp_path_factory.mktemp("trainers") / "jobs.pt", jobs)
    one = W.one_process(ones)
    return {name: ([r[name] for r in ranks], one[name], weights[name]) for name in TRAINERS}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_banded_trainers_as_one_process(trainers, trainer):
    """The WQ family, da, cda, the source-available adaptive teacher and the
    other source-free variants with bands on data 1 x model 2 against one
    process (test_torch_parallel.py:test_trainers_on_two_ranks_as_one's
    weights, batches and bounds): the domain classifiers and the teachers'
    train-mode BatchNorm take the gathered maps."""
    ranks, one, sd = trainers[trainer]
    check_trainer(trainer, ranks, one, sd)


def test_banded_eval_and_adabn_as_one_process(tmp_path):
    """test() (3 batches of the tiny backbone at 128x256, each banded over
    both ranks) and AdaBN over 2 global batches against one process."""
    job = dict(job="eval_adabn", opts=EVAL_OPTS + SPATIAL, output_dir=str(tmp_path / "two"), per_rank_dir=True)
    ranks = W.spawn(tmp_path / "jobs.pt", [("e", job)])
    one = W.one_process([("e", dict(job, opts=EVAL_OPTS, output_dir=str(tmp_path / "one"), per_rank_dir=False))])["e"]
    assert ranks[0]["e"]["test"] == ranks[1]["e"]["test"] == one["test"]
    assert ranks[0]["e"]["files"] == one["files"] and "adabn.pth" in one["files"]
    assert ranks[1]["e"]["files"] == [] and ranks[1]["e"]["dump"] is None
    assert json.loads(ranks[0]["e"]["dump"]) == json.loads(one["dump"]) and len(json.loads(one["dump"])) > 10
    for k, v in one["bn"].items():
        scale = one["bn"][k.replace("running_mean", "running_var")].sqrt().max() if "mean" in k else v.max()
        for r in ranks:
            assert (r["e"]["bn"][k] - v).abs().max() <= 1e-5 * scale, k
    assert set(one["adabn"]) == set(ranks[0]["e"]["adabn"])


def test_banded_cli_and_checkpoint(tmp_path):
    """train_net --num-gpus 2 with bands (VGG16 at 128x256: 4 units of 32
    rows), evaluating at its last step; its model_final.pth loads strictly
    into one process; train_net_mt --eval-only (AdaBN) on 2 banded
    processes from it."""
    out = tmp_path / "run"
    p = run_cli("train_net", *CLI, "--num-gpus", "2", "OUTPUT_DIR", str(out), *CLI_CUTS, *SPATIAL,
                "TEST.EVAL_PERIOD", "2")
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr[-3000:]
    assert stdout.count("[launches] ") == 2 and stdout.count("[eval] synthetic_test") == 2
    hashes = {ln.split("sha256 ")[1][:64] for ln in stdout.split("[state] rank ")[1:]}
    assert len(hashes) == 1, hashes
    data = torch.load(out / "model_final.pth", weights_only=True)
    assert data["iteration"] == 2 and data["model"]["roi_heads.box_head.fc1.weight"].shape[0] == 64
    cfg = get_cfg()
    cfg.merge_from_file(CLI[1], allow_new=True)
    cfg.merge_from_list(CLI_CUTS + ["OUTPUT_DIR", str(tmp_path / "one")])
    one = build_trainer(cfg, device="cpu", synthetic=True)
    one.load_checkpoint(data)
    assert all(torch.equal(v, data["model"][k]) for k, v in one.state.model.state_dict().items())

    p = run_cli("train_net_mt", *CLI, "--eval-only", "--adabn-batches", "2", "--num-gpus", "2", "MODEL.WEIGHTS",
                str(out / "model_final.pth"), "OUTPUT_DIR", str(tmp_path / "eval"), *CLI_CUTS, *SPATIAL)
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr[-3000:]
    assert stdout.count("[adabn] BatchNorm statistics refined over 2 batches") == 2
    assert sorted(os.listdir(tmp_path / "eval")) == ["adabn.pth", "eval_results.json", "inference", "last_checkpoint"]


def test_spatial_shard_without_model_axis_raises(tmp_path):
    """The JAX package's tests/test_sharding.py case: a set key that would
    change nothing fails."""
    from simple_sfod_tpu_torch.parallel.dryrun import tiny_cfg

    cfg = tiny_cfg(1, output_dir=str(tmp_path), spatial=True)
    with pytest.raises(ValueError, match="SPATIAL_SHARD.*MESH_MODEL"):
        build_trainer(cfg, device="cpu")
