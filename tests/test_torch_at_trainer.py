"""The port's source-available Adaptive Teacher against the JAX package's,
step for step, on the CPU in float32; its weights crossing, resume and CLI.

The lockstep builds the JAX AdaptiveTeacherTrainer from
configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml (cut to a
64x128 canvas with 60x120 images, batch 2 + 2, FC_DIM 64, take-all ROI
sampling, float32, BURN_UP_STEP 1, EMA_KEEP_RATE 0.99) and runs its
`_step_fn_raw` under jit; the port's trainer takes each step from the JAX
step's input state (checkpoint/from_jax.py:teacher_student_from_jax) with the
JAX step's draws (fold_in(rng, step) -> split 7 -> (flip_s, flip_t, strong,
sup, unsup, dc, strong_s)) and flax's dropout masks
(test_torch_sfat_trainer.py:flax_dropout_masks). The weights are
test_torch_sfat_trainer.py's: the class-1 logit bias raised by 4, the
regression kernels zero, the student's regression biases 1e-2 off the
teacher's.

Step 0 is burn-in (the pseudo and classifier losses weighted 0), step 1 the
boundary (the teacher a copy of the student before its pseudo forward),
step 2 joint with the EMA. The TEACHER_UPDATE_ITER 2 case runs to step 3 and
pins the JAX package's EMA phase: the EMA at the end of step S when
(S - BURN_UP_STEP) % T == 0 (step 3, not step 2); the reference's
counterpart of that update is (S + 1 - BURN_UP_STEP) % T == 0 (step 2), a
one-step offset that the port keeps with the JAX package.

Held at every step: the metrics' keys, num_pseudo, the counts, each loss
1e-4 relative; the student and the domain classifiers by the
movement-relative rule (test_torch_trainer.py); the teacher's parameters
exactly in burn-in and at the boundary (the copy), its statistics that its
pseudo forward moved within 1e-5 of each buffer's largest entry, and after an
EMA the port's own keep * t + (1 - keep) * s to 1e-6 and the JAX teacher by
the movement rule.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu_torch.checkpoint.from_jax import teacher_student_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.train_state import ema_tensors
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.adaptive_teacher import ATDraws, AdaptiveTeacherTrainer
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from test_torch_sfat_ops import jax_strong_draws
from test_torch_sfat_trainer import (
    BBOX_OFFSET,
    bn_fed_bias,
    boost,
    flax_dropout_masks,
    inert_bias_ok,
    load_jax_state,
    max_rel,
)
from test_torch_train_model import jax_loss_draws
from test_torch_trainer import rel_err, within_tolerance

ROOT = os.path.join(os.path.dirname(__file__), "..")
AT_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml")
CANVAS = (64, 128)
IMAGE_HW = (60, 120)
BATCH = 2
GT_CAP = 8
KEEP = 0.99
OPTS = {
    "TPU": {"CANVAS": CANVAS, "GT_CAPACITY": GT_CAP, "MESH_DATA": 1, "DTYPE": "float32"},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 256},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 256, "POSITIVE_FRACTION": 1.0}},
    "SOLVER": {"IMS_PER_BATCH": BATCH, "IMS_PER_BATCH_TARGET": BATCH, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
    "SEMISUPNET": {"BURN_UP_STEP": 1, "EMA_KEEP_RATE": KEEP},
}
CASES = {  # name: (extra opts, steps, the steps whose end runs the EMA)
    "instance_dc": ({"SEMISUPNET": {"INS_DC": True}}, 3, {2}),
    "update_iter_2_pinned": ({"SEMISUPNET": {"TEACHER_UPDATE_ITER": 2}}, 4, {3}),
}
SUP = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
LOSSES = SUP + tuple(f"{k}_pseudo" for k in SUP) + ("total_loss",)


@pytest.fixture(autouse=True)
def two_threads(tmp_path):
    """Each test on 2 torch threads; its directory removed after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    shutil.rmtree(tmp_path, ignore_errors=True)


def at_cfg(get, tmp_path, extra=None, *opts):
    cfg = get()
    cfg.merge_from_file(AT_YAML)
    cfg.merge_from_list(config_opts(OPTS) + config_opts(extra or {}) + list(opts))
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def batches(steps, seed=3):
    """(source with GT, target) batch pairs at the lockstep's size."""
    recs = make_synthetic_records(2 * BATCH * steps, IMAGE_HW, 8, 6, seed=seed)
    return [(synthetic_batch(recs[2 * i * BATCH:(2 * i + 1) * BATCH], CANVAS, GT_CAP),
             synthetic_batch(recs[(2 * i + 1) * BATCH:(2 * i + 2) * BATCH], CANVAS, GT_CAP)) for i in range(steps)]


def jax_at_draws(base_rng, step, num_anchors, pools, masks):
    """The draws of the JAX AT step `step`, with flax's masks of it."""
    k_flip_s, k_flip_t, k_strong, k_sup, k_unsup, _, k_strong_s = jax.random.split(jax.random.fold_in(base_rng, step), 7)
    flip = [torch.from_numpy(np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(key, BATCH)]))
            for key in (k_flip_s, k_flip_t)]
    rpn, roi = jax_loss_draws(k_sup, 2 * BATCH, num_anchors, pools[0])
    rpn_t, roi_t = jax_loss_draws(k_unsup, BATCH, num_anchors, pools[1])
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return ATDraws(flip[0], jax_strong_draws(jax.random.split(k_strong_s, BATCH), CANVAS), t(rpn), t(roi), flip[1],
                   jax_strong_draws(jax.random.split(k_strong, BATCH), CANVAS), t(rpn_t), t(roi_t),
                   tuple(torch.from_numpy(m.copy()) for m in masks) if masks else None)


@pytest.mark.parametrize("name", list(CASES))
def test_lockstep_against_jax_at_step(tmp_path, name):
    extra, steps, ema_steps = CASES[name]
    jtr = jax_build_trainer(at_cfg(jax_get_cfg, tmp_path, extra))
    state = jtr.state
    params = dict(state.params, det=boost(state.params["det"], {1: 4.0}, BBOX_OFFSET))
    state = state.replace(params=params, teacher_params=boost(state.teacher_params, {1: 4.0}))
    pcfg_node = at_cfg(get_cfg, tmp_path, extra)
    pcfg = detector_config_from_cfg(pcfg_node)
    ptr = build_trainer(pcfg_node, device="cpu", weights=teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg))
    assert isinstance(ptr, AdaptiveTeacherTrainer) and ptr.ema_enabled and set(ptr.state.dc) == (
        {"dc", "dc_ins"} if name == "instance_dc" else {"dc"})
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pools = (roi_pool_size(pcfg, n, GT_CAP), roi_pool_size(pcfg, n, pcfg.detections_per_image))
    moved, dc_losses_seen = 0, []
    with flax_dropout_masks() as masks:
        jax_step = jax.jit(jtr._step_fn_raw)
        for step, (src, tgt) in enumerate(batches(steps)):
            if step:
                load_jax_state(ptr, state, pcfg)
            start = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
            state, jm = jax_step(state, jnp.asarray(src["images"]), jnp.asarray(src["sizes"]), jax_gt_instances(src),
                                 jnp.asarray(tgt["images"]), jnp.asarray(tgt["sizes"]), jtr.base_rng)
            jax.effects_barrier()
            assert len(masks) == (4 if ptr.ins_dc_enabled else 0)
            want = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
            teacher_before = [x.clone() for x in ema_tensors(ptr.state.teacher)]
            pm = ptr.run_step(src, jax_at_draws(jtr.base_rng, step, n, pools, masks), target=tgt)

            assert set(pm) == set(jm), sorted(set(pm) ^ set(jm))
            assert int(pm["num_pseudo"]) == int(jm["num_pseudo"]) > 0, step
            for k in [k for k in pm if k.startswith("num_")]:
                assert int(pm[k]) == int(jm[k]), (step, k)
            dc_keys = [k for k in pm if k.startswith("loss_DC")]
            for k in LOSSES + tuple(dc_keys):
                assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (step, k, float(pm[k]), float(jm[k]))
            dc_losses_seen.append(sum(float(pm[k]) for k in dc_keys))
            if step == 0:  # burn-in: the total is the supervised one alone
                sup = sum(float(pm[k]) for k in SUP)
                assert rel_err(float(pm["total_loss"]), sup) <= 1e-5
            assert ptr.state.step == int(state.step) == step + 1

            got = ptr.state.model.state_dict()
            bad = [k for k in want.student if not k.endswith("num_batches_tracked")
                   and not (inert_bias_ok(got, start.student, k) if bn_fed_bias(k)
                            else within_tolerance(got[k], want.student[k], start.student[k]))]
            assert not bad, (step, bad)
            moved += sum(not torch.equal(got[k], start.student[k]) for k in want.student)
            for dc_name, module in ptr.state.dc.items():
                for k, v in module.state_dict().items():
                    assert within_tolerance(v, want.dc[dc_name][k], start.dc[dc_name][k]), (step, dc_name, k)

            teacher = ptr.state.teacher.state_dict()
            n_params = len(list(ptr.state.teacher.parameters()))
            if step in ema_steps:
                for t0, t1, s1 in list(zip(teacher_before, ema_tensors(ptr.state.teacher), ema_tensors(ptr.state.model)))[:n_params]:
                    np.testing.assert_allclose(t1.numpy(), (KEEP * t0 + (1 - KEEP) * s1).numpy(), rtol=1e-6, atol=1e-7)
            for k, w in want.teacher.items():
                if k.endswith("num_batches_tracked") or k.startswith("pixel_"):
                    continue
                if k.endswith(("running_mean", "running_var")):
                    if step not in ema_steps:  # moved by the pseudo forward alone
                        assert max_rel(teacher[k], w) <= 1e-5, (step, k)
                    else:
                        assert within_tolerance(teacher[k], w, start.teacher[k]), (step, k)
                elif step in ema_steps:
                    assert bn_fed_bias(k) or within_tolerance(teacher[k], w, start.teacher[k]), (step, k)
                else:
                    # burn-in: the teacher's parameters as they were; the boundary
                    # and a step without EMA: the copy of the step's input student
                    base = start.teacher[k] if step < OPTS["SEMISUPNET"]["BURN_UP_STEP"] else (
                        start.student[k] if step == OPTS["SEMISUPNET"]["BURN_UP_STEP"] else start.teacher[k])
                    assert torch.equal(teacher[k], base) and torch.equal(w, base), (step, k)
    assert moved > 50
    assert dc_losses_seen[0] > 0  # the classifiers' losses are computed in burn-in too, at weight 0
    if name == "update_iter_2_pinned":
        # the JAX phase, pinned: no EMA at the end of step 2, where the
        # reference's counterpart condition (S + 1 - burn_up) % T holds
        assert (2 + 1 - 1) % 2 == 0 and 2 not in ema_steps


def test_from_jax_at_state_key_for_key(tmp_path):
    """teacher_student_from_jax of a JAX AT state: the port trainer's
    student, teacher and classifier keys exactly; the values load strictly."""
    extra = CASES["instance_dc"][0]
    jtr = jax_build_trainer(at_cfg(jax_get_cfg, tmp_path, extra))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state)
    pcfg_node = at_cfg(get_cfg, tmp_path, extra)
    w = teacher_student_from_jax(tree, detector_config_from_cfg(pcfg_node))
    ptr = build_trainer(pcfg_node, device="cpu", weights=w)
    assert set(w.student) == set(ptr.state.model.state_dict()) == set(w.teacher)
    assert set(w.dc) == set(ptr.state.dc) == {"dc", "dc_ins"}
    for name, m in ptr.state.dc.items():
        assert set(w.dc[name]) == set(m.state_dict())
        for k, v in m.state_dict().items():
            assert torch.equal(v, w.dc[name][k]), (name, k)
    np.testing.assert_array_equal(ptr.state.model.state_dict()["roi_heads.box_predictor.cls_score.weight"].numpy(),
                                  tree.params["det"]["predictor"]["cls_score"]["kernel"].T)
    assert all(p.dtype == torch.float32 for p in ptr.state.teacher.parameters())  # an EMA teacher


class Repeat:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def small_at(tmp_path, *opts):
    cfg = at_cfg(get_cfg, tmp_path, None, "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
                 "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", *opts)
    tr = build_trainer(cfg, device="cpu")
    with torch.no_grad():
        for m in (tr.state.model, tr.state.teacher):
            m.roi_heads.box_predictor.cls_score.bias[1] += 4.0
    src, tgt = (synthetic_batch([r], CANVAS, GT_CAP) for r in make_synthetic_records(2, IMAGE_HW, 8, 6, seed=5))
    tr.train_loader = Repeat(src)
    tr._build_target_loader = lambda: Repeat(tgt)
    return tr


def test_resume_is_bit_equal_across_the_boundary(tmp_path):
    """4 steps straight (burn-in 1, EMA from step 2) against 2 steps, a
    checkpoint and a resumed trainer for 2 more: student, teacher,
    classifier, momentum and step bit-equal."""
    straight = small_at(tmp_path / "a", "SOLVER.MAX_ITER", "4")
    straight.train()
    small_at(tmp_path / "b", "SOLVER.MAX_ITER", "2").train()
    resumed = small_at(tmp_path / "b", "SOLVER.MAX_ITER", "4")
    resumed.resume_or_load(resume=True)
    assert resumed.state.step == 2
    resumed.train()
    a, b = straight.checkpoint_state(), resumed.checkpoint_state()
    assert a["iteration"] == b["iteration"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["optimizer"]["mu"].items():
        assert torch.equal(v, b["optimizer"]["mu"][k]), k
    for k, v in a["trainer"]["dc"]["dc"].items():
        assert torch.equal(v, b["trainer"]["dc"]["dc"][k]), k
    teacher = {k: v for k, v in a["model"].items() if k.startswith("modelTeacher.")}
    student = {k[len("modelTeacher."):]: v for k, v in teacher.items()}
    assert any(not torch.equal(v, a["model"][f"modelStudent.{k}"]) for k, v in student.items())


def test_train_net_mt_on_the_at_yaml(tmp_path):
    """`python -m simple_sfod_tpu_torch.tools.train_net_mt` on the AT YAML, 2
    iterations across a burn-in of 1 on --synthetic data at 64x128: exit 0,
    finite losses in metrics.json, model_final.pth with both models,
    eval_results.json with student and teacher, the launches line."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "simple_sfod_tpu_torch.tools.train_net_mt", "--config-file", AT_YAML, "--synthetic",
           "--device", "cpu", *config_opts(OPTS), "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
           "SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "2", "OUTPUT_DIR", str(out), "DATALOADER.NUM_WORKERS", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [json.loads(x) for x in open(out / "metrics.json")]
    assert lines[-1]["iteration"] == 1
    assert all(np.isfinite(lines[-1][k]) for k in ("loss_DC_img_s", "loss_cls_pseudo", "total_loss"))
    data = torch.load(out / "model_final.pth", weights_only=True)
    assert any(k.startswith("modelTeacher.") for k in data["model"]) and set(data["trainer"]["dc"]) == {"dc"}
    with open(out / "eval_results.json") as f:
        ev = json.load(f)
    assert {k.rsplit("/", 1)[1] for k in ev} == {"student", "teacher"}
    last = res.stdout.strip().splitlines()[-1]
    assert json.loads(last[len("[launches] "):]) == {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}


def test_make_draws_sizes(tmp_path):
    """The trainer's own draws: 2B supervised priorities over the GT pool,
    B_t pseudo ones over the detections' pool, masks over the training
    proposals where the instance classifier is built; the same seed, the
    same draws."""
    cfg = at_cfg(get_cfg, tmp_path, CASES["instance_dc"][0])
    a, b = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cpu")
    da, db = a.make_draws(2, CANVAS, GT_CAP, 3), b.make_draws(2, CANVAS, GT_CAP, 3)
    pcfg = detector_config_from_cfg(cfg)
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    assert da.rpn.shape == (4, n) and da.roi.shape == (4, roi_pool_size(pcfg, n, GT_CAP))
    assert da.rpn_t.shape == (3, n) and da.roi_t.shape == (3, roi_pool_size(pcfg, n, pcfg.detections_per_image))
    assert [m.shape[0] for m in da.dropout] == [2 * n, 2 * n, 3 * n, 3 * n]  # post-NMS cap = anchors here
    assert torch.equal(da.rpn, db.rpn) and all(torch.equal(x, y) for x, y in zip(da.dropout, db.dropout))
