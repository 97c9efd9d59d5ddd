"""The port's fixed-pseudo-label trainers (engine/trainers/wq.py) against
the JAX package's WQTrainer, step for step, on the CPU in float32; the
registry, the draws and resume around them.

The lockstep builds the JAX trainer from the WQ YAMLs (its constructor needs
no dataset) and runs its raw step function, `_step_fn_raw`, under jit for 2
steps; the port's trainer starts from the same weights
(checkpoint/from_jax.py) and gets the JAX step's own draws, extracted from
its key schedule fold_in(rng, step) -> split 4 -> (flip, mix, strong, loss):
the flip bernoullis, the mosaic centres, the affine's, the mixup flip's,
jitter's and crop's draws (tests/test_torch_mosaic.py), the strong view's
(tests/test_torch_sfat_ops.py) and both samplers' priorities, the ROI pool
sized for the augmented GT capacity. VGG16-BN at a 64x128 canvas with
60x120 content, batch 2, FC_DIM 64, an RPN batch of 64 and an ROI batch of
32, warmup inside the 2 steps.

Tolerances: tests/test_torch_trainer.py's. The fg and sampled counts equal
at every step, each loss within 1e-4 relative, and after the 2 steps each
parameter and BatchNorm statistic within 1e-4 of its tensor's largest entry
plus 25% of how far the steps moved it, plus 1e-8 (`within_tolerance`,
whose docstring gives the reasons).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers import TRAINER_REGISTRY as JAX_REGISTRY
from simple_sfod_tpu.engine.trainers import _import_all
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import TRAINER_REGISTRY, build_trainer
from simple_sfod_tpu_torch.engine.trainers.wq import GT_GROWTH, WQDraws, WQTrainer
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from test_torch_mosaic import jax_affine_draws, jax_mixup_draws, jax_mosaic_centre
from test_torch_sfat_ops import jax_strong_draws
from test_torch_train_model import jax_loss_draws
from test_torch_trainer import LOSSES, rel_err, within_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {aug: os.path.join(ROOT, "configs", f"faster_rcnn_VGG_cityscapes_foggy_source_{aug}.yaml")
         for aug in ("wq", "mosaic", "mixup", "mosaic_wq_new")}
CANVAS = (64, 128)
IMAGE_HW = (60, 120)
GT_CAP = 8
BATCH = 2
STEPS = 2
LOCKSTEP_OPTS = {
    "TPU": {"CANVAS": CANVAS, "GT_CAPACITY": GT_CAP, "MESH_DATA": 1},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 64},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 32}},
    "SOLVER": {"IMS_PER_BATCH": BATCH, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
}
# name -> (YAML, extra KEY VALUE opts)
CASES = {
    "wq": ("wq", []),
    "mosaic": ("mosaic", []),
    "mixup": ("mixup", []),
    "mosaic_wq": ("mosaic_wq_new", []),
    "mosaic_affine": ("mosaic", ["INPUT.MOSAIC.RANDOM_AFFINE", "True"]),
    "mixup_jitter": ("mixup", ["INPUT.MIXUP.SCALE_JITTER", "(0.8, 1.6)"]),
}


@pytest.fixture(autouse=True)
def two_threads(tmp_path):
    """2 torch threads (the suite's workers share the cores), and the test's
    directory removed after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    shutil.rmtree(tmp_path, ignore_errors=True)


def case_cfg(get, tmp_path, name):
    yaml, extra = CASES[name]
    cfg = get()
    cfg.merge_from_file(YAMLS[yaml], allow_new=True)
    cfg.merge_from_list(config_opts(LOCKSTEP_OPTS) + extra)
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def jax_wq_draws(base_rng, step, aug, batch, sizes, num_anchors, pool, affine, mixup_jitter) -> WQDraws:
    """The draws of the JAX WQ step `step`: fold_in(rng, step) -> split 4 ->
    (flip, mix, strong, loss); mosaic from the mix key (the affine from its
    fold_in 1), mixup from the mix key's fold_ins 0, 1, 2."""
    rng = jax.random.fold_in(base_rng, step)
    rng_flip, rng_mix, rng_strong, rng_loss = jax.random.split(rng, 4)
    flip = torch.from_numpy(np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(rng_flip, batch)]))
    mosaic = affine_u = mixup_flip = jitter = jitter_offset = crop = strong = None
    if aug in ("mosaic", "mosaic_wq"):
        mosaic = jax_mosaic_centre(rng_mix, batch)
        if affine:
            affine_u = jax_affine_draws(jax.random.fold_in(rng_mix, 1), batch)
    if aug == "mixup":
        mixup_flip, jitter, jitter_offset, crop = jax_mixup_draws(rng_mix, batch, CANVAS, sizes)
        if not mixup_jitter:
            jitter = jitter_offset = None
    if aug in ("wq", "mosaic_wq"):
        strong = jax_strong_draws(jax.random.split(rng_strong, batch), CANVAS)
    rpn, roi = jax_loss_draws(rng_loss, batch, num_anchors, pool)
    return WQDraws(flip, mosaic, affine_u, mixup_flip, jitter, jitter_offset, crop, strong,
                   torch.from_numpy(np.array(rpn)), torch.from_numpy(np.array(roi)))


def batches(steps, seed=3):
    records = make_synthetic_records(BATCH * steps, IMAGE_HW, 8, 6, seed=seed)
    return [synthetic_batch(records[i * BATCH:(i + 1) * BATCH], CANVAS, GT_CAP) for i in range(steps)]


@pytest.mark.parametrize("name", list(CASES))
def test_lockstep_against_jax_wq_step(tmp_path, name):
    jtr = jax_build_trainer(case_cfg(jax_get_cfg, tmp_path, name))
    jax_step = jax.jit(jtr._step_fn_raw)
    pcfg_node = case_cfg(get_cfg, tmp_path, name)
    pcfg = detector_config_from_cfg(pcfg_node)
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    start = state_dict_from_jax(init, pcfg)
    ptr = build_trainer(pcfg_node, device="cpu", state_dict=start)
    assert isinstance(ptr, WQTrainer) and type(ptr).__name__ == type(jtr).__name__ and ptr.aug == jtr.aug
    assert ptr.affine == bool(pcfg_node.INPUT.MOSAIC.RANDOM_AFFINE)

    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_GROWTH[ptr.aug] * GT_CAP)
    state = jtr.state
    for step, batch in enumerate(batches(STEPS)):
        state, jm = jax_step(state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]), jax_gt_instances(batch),
                             jtr.base_rng)
        draws = jax_wq_draws(jtr.base_rng, step, ptr.aug, BATCH, batch["sizes"], n, pool, ptr.affine, ptr.mixup_jitter)
        pm = ptr.run_step(batch, draws)
        assert set(pm) == set(jm)
        for k in LOSSES:
            assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (step, k, float(pm[k]), float(jm[k]))
        for k in ("num_fg", "num_sampled"):
            assert int(pm[k]) == int(jm[k]), (step, k)
        assert int(pm["num_fg"]) > 0
    assert ptr.state.step == STEPS == int(state.step)

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    moved = [k for k in want if np.abs((want[k] - start[k]).numpy()).max() > 1e-3 * np.abs(want[k].numpy()).max()]
    assert len(moved) > 30


def test_registrations_build_from_the_four_yamls(tmp_path):
    """The five names are registered (base_mosaic_wq_new is mosaic_wq, as
    in the JAX package); each WQ YAML builds its trainer and takes a step."""
    want = {"base_wq": "wq", "base_mosaic": "mosaic", "base_mixup": "mixup", "base_mosaic_wq": "mosaic_wq",
            "base_mosaic_wq_new": "mosaic_wq"}
    _import_all()
    for name, aug in want.items():
        assert issubclass(TRAINER_REGISTRY[name], WQTrainer) and TRAINER_REGISTRY[name].aug == aug
        assert JAX_REGISTRY[name].__name__ == TRAINER_REGISTRY[name].__name__ and JAX_REGISTRY[name].aug == aug
    batch = batches(1)[0]
    for yaml, path in YAMLS.items():
        cfg = get_cfg()
        cfg.merge_from_file(path, allow_new=True)
        assert cfg.SOLVER.IMS_PER_BATCH == 4 and tuple(cfg.TPU.CANVAS) == (608, 1216) and cfg.TPU.DTYPE == "float32"
        assert cfg.DATASETS.TRAIN == ("cityscapes_instancesonly_foggy_train_adabn",)
        cfg.merge_from_list(config_opts(LOCKSTEP_OPTS) + ["OUTPUT_DIR", str(tmp_path)])
        tr = build_trainer(cfg, device="cpu")
        assert tr.aug == want[cfg.TRAINER]
        m = tr.run_step(batch)
        assert all(torch.isfinite(m[k]) for k in LOSSES), (yaml, m)


@pytest.mark.parametrize("aug", ["wq", "mosaic", "mixup", "mosaic_wq"])
def test_draws_are_sized_for_the_augmented_gt(tmp_path, aug):
    """WQDraws holds what its aug uses, and the ROI priorities cover the
    proposals plus the augmented GT capacity: 4N after mosaic, 2N after
    mixup. The same seed draws the same."""
    name = {"wq": "wq", "mosaic": "mosaic_affine", "mixup": "mixup_jitter", "mosaic_wq": "mosaic_wq"}[aug]
    cfg = case_cfg(get_cfg, tmp_path, name)
    tr = build_trainer(cfg, device="cpu")
    d = tr.make_draws(BATCH, CANVAS, GT_CAP)
    n = anchors_for(tr.det_cfg, CANVAS, torch.device("cpu")).shape[0]
    growth = {"wq": 1, "mosaic": 4, "mosaic_wq": 4, "mixup": 2}[aug]
    assert d.rpn.shape == (BATCH, n) and d.roi.shape == (BATCH, roi_pool_size(tr.det_cfg, n, growth * GT_CAP))
    assert d.roi.shape[1] > roi_pool_size(tr.det_cfg, n, GT_CAP) or growth == 1
    assert (d.mosaic is not None) == (aug in ("mosaic", "mosaic_wq"))
    assert (d.affine is not None) == (aug == "mosaic")
    assert all(getattr(d, f) is not None for f in ("mixup_flip", "jitter", "jitter_offset", "crop")) == (aug == "mixup")
    assert (d.strong is not None) == (aug in ("wq", "mosaic_wq"))
    again = build_trainer(cfg, device="cpu").make_draws(BATCH, CANVAS, GT_CAP)
    for a, b in zip(d, again):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    m = tr.run_step(batches(1)[0])
    assert all(isinstance(v, torch.Tensor) and not v.requires_grad for v in m.values())
    assert int(m["num_sampled"]) == BATCH * tr.det_cfg.roi_batch_size_per_image


class RepeatBatch:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def resume_trainer(tmp_path, out, max_iter, resume=False):
    cfg = case_cfg(get_cfg, tmp_path, "mosaic_wq")
    cfg.merge_from_list(["SOLVER.MAX_ITER", str(max_iter), "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
                         "SOLVER.WARMUP_ITERS", "0", "OUTPUT_DIR", str(out)])
    tr = build_trainer(cfg, device="cpu")
    tr.resume_or_load(resume=resume)
    tr.train_loader = RepeatBatch(batches(1, seed=5)[0])
    return tr


def test_resume_is_bit_equal(tmp_path):
    """base_mosaic_wq_new (mosaic and the strong view: both generators) for
    4 steps straight, and 2 + resume + 2: weights, statistics, momentum,
    the schedule's count and both generators bit-equal."""
    straight = resume_trainer(tmp_path, tmp_path / "straight", 4)
    straight.train()
    resume_trainer(tmp_path, tmp_path / "split", 2).train()
    second = resume_trainer(tmp_path, tmp_path / "split", 4, resume=True)
    assert second.state.step == 2
    second.train()
    assert second.state.step == straight.state.step == 4 and second.state.optimizer.count == 4
    for a, b in ((straight.state.model.state_dict(), second.state.model.state_dict()),
                 (straight.state.optimizer.state_dict()["mu"], second.state.optimizer.state_dict()["mu"])):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(straight.generator.get_state(), second.generator.get_state())
    assert torch.equal(straight.host_generator.get_state(), second.host_generator.get_state())
