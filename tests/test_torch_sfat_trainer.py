"""The port's source-free adaptive-teacher step against the JAX trainer's,
step for step, on the CPU in float32; and the refusals around it.

Each case builds the JAX trainer itself (its constructor needs no dataset)
and runs its raw step function, `_step_fn_raw`, under jit for 3 steps. The
port's trainer takes each step from the JAX step's input state (student,
teacher, domain classifiers, threshold statistics, SGD momentum, step;
checkpoint/from_jax.py) and gets the JAX step's own draws: the flip
bernoullis, the strong view's draws and the student's sampler priorities,
extracted from the JAX key schedule fold_in(rng, step) -> split 4 -> (flip,
strong, loss, dc). VGG16-BN at a 64x128 canvas with 60x120 images, batch 2,
FC_DIM 64, take-all sampling (RPN batch 256 over 120 anchors, ROI batch
256 at positive fraction 1 over 220 candidates), warmup inside the 3 steps.

The weights, as in tests/sfat_lockstep_runner.py: the class-1 logit bias is
raised by 4 in student and teacher, so random weights give pseudo-labels
above 0.8, and the student's regression biases (box head and RPN) are
offset by 1e-2 from the teacher's, so its L1 regression losses are not at
their structural zero (where the gradient is the sign of rounding noise).
And the RPN's and the box head's regression kernels start at 0 in both, so
that the teacher's pseudo boxes are decoded from the biases alone, the same
float32 operations on the same anchors in both packages. With random
kernels the pseudo boxes differ by rounding (up to 4e-4 px, measured), and
that can flip an anchor's RPN label: in case a's first step loss_rpn_loc
moved 1.7% (measured) while the JAX loss itself, on the port's pseudo
boxes, equals the port's (test_random_kernels_step_equals_jax_losses_on_
its_pseudo_labels). For the same reason each step starts from the JAX
state: run free, the two trajectories differ by the movement rule below
after one update, and the losses after two by up to 3% (measured).

Cases:
  a  the main variant with the strong view and the adaptive threshold on
     (WARM_UP 1, RESERVE 2: the adaptive branch from step 1, the reserve
     wrapping at step 2); class 5's logit bias is also raised (by 2.5, with
     class 1's by 5), so that its detections sit between the adaptive and
     the fixed threshold and the adaptive branch changes the pseudo-labels
  b  the main variant on the main configuration's keys: domain classifiers
     built and zero-weighted, no strong view, adaptive threshold off
  c  `_single`, with SPLIT_VIEW_BN False (one fused pass) and True
  d  `_mosaic`, one step
  e  configs/r101_c4_cs_foggy_adaptive_teacher_source_free.yaml (ResNet-101
     C4 with live BN, FREEZE_AT 2) on a cut block plan (1, 1, 2 blocks up
     to res4), with the domain classifiers built on res4's 1024 channels
     and zero-weighted; 2 steps. The stem and res2 parameters stay
     bit-identical; their running statistics move, in both packages
  f  the main configuration with DOMAIN_CLASSIFIER.IMAGE weighted; 2 steps
  g  the same with DOMAIN_CLASSIFIER.INSTANCE weighted, on flax's dropout
     masks (`flax_dropout_masks`); 2 steps
  h  the same with both weighted; 2 steps
  i  `_single` under SPLIT_VIEW_BN with both weighted (the weak pass then
     carries the classifiers' gradient); 2 steps

Held at every step: num_pseudo and the pseudo-label sets (classes equal,
boxes within 1e-3 px, against the JAX pipeline on the same state and
draws); each loss 1e-4 relative at steps 1 and 2 and 1e-3 at step 3; the
threshold state exactly; the student's weights and statistics, and the
domain classifiers', by test_torch_trainer.py's movement-relative rule
(1e-4 of the tensor's largest entry plus 25% of the step's movement), with
the conv biases that feed a BatchNorm held to moving less than 1e-3 of
their conv's movement (their exact gradient is 0); the teacher's
parameters exactly (fixed teacher), or the port's own
keep * t + (1 - keep) * s to 1e-6 and the JAX teacher by the movement rule
(EMA); the statistics that the teacher's pseudo forward moves within 1e-5
of each buffer's largest entry.
"""

import contextlib
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data import transforms as JT
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.engine.trainers.base import apply_weak_aug as jax_apply_weak_aug
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.checkpoint.from_jax import dc_state_dict_from_jax, state_dict_from_jax, teacher_student_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG, SFAT_BENCH_CONFIG, config_opts
from simple_sfod_tpu_torch.engine.train_state import ema_tensors
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.source_free_adaptive_teacher import (
    AdaptDraws,
    SourceFreeAdaptiveTeacherTrainer,
)
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from test_torch_sfat_ops import jax_strong_draws
from test_torch_train_model import jax_loss_draws
from test_torch_trainer import rel_err, within_tolerance

CANVAS = (64, 128)
IMAGE_HW = (60, 120)
BATCH = 2
STEPS = 3
LOSSES = ("loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo", "loss_cls_pseudo", "loss_box_reg_pseudo", "loss_bpc_pseudo", "total_loss")
LOCKSTEP_OPTS = {
    "TPU": {"CANVAS": CANVAS, "MESH_DATA": 1, "DTYPE": "float32"},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 256},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 256, "POSITIVE_FRACTION": 1.0}},
    "SOLVER": {"IMS_PER_BATCH_TARGET": BATCH, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
    "SEMISUPNET": {"EMA_KEEP_RATE": 0.99},
}
CASES = {
    "a_main_strong_adaptive": (SFAT_BENCH_CONFIG, {"ADAPTIVE_THRESHOLD": {"WARM_UP": 1, "RESERVE": 2}}, STEPS, {1: 5.0, 5: 2.5}),
    "b_main_config_dc": (MAIN_CONFIG, {}, STEPS, {1: 4.0}),
    "c_single_fused": (SFAT_BENCH_CONFIG, {"TRAINER": "source_free_adaptive_teacher_single"}, STEPS, {1: 4.0}),
    "c_single_split_view_bn": (
        SFAT_BENCH_CONFIG,
        {"TRAINER": "source_free_adaptive_teacher_single", "SEMISUPNET": {"SPLIT_VIEW_BN": True}},
        STEPS,
        {1: 4.0},
    ),
    "d_mosaic": (SFAT_BENCH_CONFIG, {"TRAINER": "source_free_adaptive_teacher_mosaic"}, 1, {1: 4.0}),
    "e_r101_yaml_dc": (
        "r101_c4_cs_foggy_adaptive_teacher_source_free.yaml",
        {"DOMAIN_CLASSIFIER": {"ENABLED": True}, "SEMISUPNET": {"INS_DC": True}},
        2,
        {1: 4.0},
    ),
    "f_weighted_image": (MAIN_CONFIG, {"DOMAIN_CLASSIFIER": {"IMAGE": True}}, 2, {1: 4.0}),
    "g_weighted_instance": (MAIN_CONFIG, {"DOMAIN_CLASSIFIER": {"INSTANCE": True}}, 2, {1: 4.0}),
    "h_weighted_both": (MAIN_CONFIG, {"DOMAIN_CLASSIFIER": {"IMAGE": True, "INSTANCE": True}}, 2, {1: 4.0}),
    "i_single_split_view_weighted": (
        MAIN_CONFIG,
        {"TRAINER": "source_free_adaptive_teacher_single", "SEMISUPNET": {"SPLIT_VIEW_BN": True},
         "DOMAIN_CLASSIFIER": {"IMAGE": True, "INSTANCE": True}},
        2,
        {1: 4.0},
    ),
}
BBOX_OFFSET = 1e-2


def case_cfg(get, tmp_path, name):
    base, extra, _, _ = CASES[name]
    cfg = get()
    if isinstance(base, str):  # a YAML of configs/
        cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", base))
        base = {}
    cfg.merge_from_list(config_opts(base) + config_opts(LOCKSTEP_OPTS) + config_opts(extra))
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def jax_closure(fn, name):
    """A function that `fn` closes over (the JAX step's pseudo_pipeline)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def boost(det_params, boosts, bbox_offset=0.0):
    """A copy of a JAX detector tree with class logit biases raised, the
    bbox_pred bias offset, and the RPN's and the box head's regression
    kernels zero (so that boxes are decoded from the biases alone, exactly
    alike in both packages: see the module docstring)."""
    tree = jax.tree_util.tree_map(lambda x: np.array(x), det_params)
    for k, v in boosts.items():
        tree["predictor"]["cls_score"]["bias"][k] += v
    tree["predictor"]["bbox_pred"]["bias"] += np.float32(bbox_offset)
    tree["rpn_head"]["deltas"]["bias"] += np.float32(bbox_offset)
    tree["predictor"]["bbox_pred"]["kernel"][:] = 0.0
    tree["rpn_head"]["deltas"]["kernel"][:] = 0.0
    return jax.tree_util.tree_map(jnp.asarray, tree)


@contextlib.contextmanager
def flax_dropout_masks():
    """Record every keep mask that flax's Dropout draws while the context is
    open, in trace order: slot i holds the mask of the i-th Dropout traced,
    refreshed by every later call of a jitted function traced here (read
    after jax.effects_barrier()). A test-only stand-in for the `random`
    module of flax.linen.stochastic passes each mask out through
    jax.debug.callback; nothing of the JAX package changes."""
    import flax.linen.stochastic as stochastic

    masks = []
    orig = stochastic.random

    def bernoulli(key, p, shape):
        m = jax.random.bernoulli(key, p, shape)
        slot = len(masks)
        masks.append(None)
        jax.debug.callback(lambda v, i=slot: masks.__setitem__(i, np.asarray(v)), m)
        return m

    stochastic.random = types.SimpleNamespace(bernoulli=bernoulli)
    try:
        yield masks
    finally:
        stochastic.random = orig


def jax_adapt_draws(base_rng, step, batch, canvas, num_anchors, pool, weak_strong, masks=()):
    """The draws of the JAX SFAT step `step`: fold_in(rng, step) -> split 4
    -> (flip, strong, loss, dc), with flax's dropout masks of the step."""
    rng = jax.random.fold_in(base_rng, step)
    rng_flip, rng_strong, rng_loss, _ = jax.random.split(rng, 4)
    flip = np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(rng_flip, batch)])
    strong = jax_strong_draws(jax.random.split(rng_strong, batch), canvas) if weak_strong else None
    rpn, roi = jax_loss_draws(rng_loss, batch, num_anchors, pool)
    dropout = tuple(torch.from_numpy(m.copy()) for m in masks) if masks else None
    return AdaptDraws(torch.from_numpy(flip), strong, torch.from_numpy(np.array(rpn)), torch.from_numpy(np.array(roi)),
                      dropout)


def jax_pseudo_fn(jtr):
    """The first half of the JAX step (flip, strong view, pseudo forward,
    pseudo_pipeline) on a state: -> the pseudo GT the step trains on."""
    det, cfg = jtr.detector, jtr.cfg
    pipeline = jax_closure(jtr._step_fn_raw, "pseudo_pipeline")
    cap = jtr.det_cfg.detections_per_image

    def f(state, images, sizes, rng):
        images = images.astype(jnp.float32)
        b = images.shape[0]
        rng_flip, rng_strong, _, _ = jax.random.split(jax.random.fold_in(rng, state.step), 4)
        empty = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), JaxInstances.empty(1))
        images_w, _ = jax_apply_weak_aug(rng_flip, images, sizes, empty, cfg.INPUT.RANDOM_FLIP != "none")
        canvas = tuple(images.shape[1:3])
        if jtr.pseudo_from_student:
            variables = {"params": state.params["det"], "batch_stats": state.batch_stats}
            if cfg.SEMISUPNET.SPLIT_VIEW_BN:
                feat_w, _ = det._features(variables, images_w, True, mutable=True)
            else:
                images_s = images_w
                if cfg.WEAK_STRONG_AUGMENT:
                    images_s = jax.vmap(JT.strong_augment)(jax.random.split(rng_strong, b), images_w, sizes)
                feat, _ = det._features(variables, jnp.concatenate([images_w, images_s]), True, mutable=True)
                feat_w = feat[:b]
        else:
            variables = state.teacher_variables()
            feat_w, _ = det._features(variables, images_w, True, mutable=True)
        dets = det.infer_from_feature(variables, feat_w, sizes, canvas, topk=cap)
        return pipeline(dets, state.thresh, state.step)[0]

    return jax.jit(f)


def batches(steps):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        images = np.zeros((BATCH, *CANVAS, 3), np.uint8)
        images[:, : IMAGE_HW[0], : IMAGE_HW[1]] = rs.randint(0, 256, (BATCH, *IMAGE_HW, 3))
        out.append({"images": images, "sizes": np.tile(np.int32(IMAGE_HW), (BATCH, 1))})
    return out


def assert_same_pseudo_labels(got, want) -> None:
    """The same pseudo-labels in each image, as sets: classes and scores
    equal in number and value, boxes within 1e-3 px (detections whose
    scores differ in the last bit may swap places in the top-k)."""
    for i in range(got.valid.shape[0]):
        gv, wv = got.valid[i].numpy(), np.asarray(want.valid[i])
        assert gv.sum() == wv.sum(), (i, gv.sum(), wv.sum())
        g = np.concatenate([got.classes[i].numpy()[gv, None], got.boxes[i].numpy()[gv]], 1)
        w = np.concatenate([np.asarray(want.classes[i])[wv, None], np.asarray(want.boxes[i])[wv]], 1)
        g, w = g[np.lexsort(np.round(g, 2).T[::-1])], w[np.lexsort(np.round(w, 2).T[::-1])]
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0, atol=1e-3)


def bn_fed_bias(key: str) -> bool:
    """A backbone conv's bias, which feeds a BatchNorm: its exact gradient is
    0 (the normalisation removes any constant), so both packages move it by
    rounding noise alone (flax's BatchNorm gradient is inexact, so its noise
    is the larger)."""
    return key.startswith("backbone.vgg") and key.endswith(".bias") and int(key.split(".")[-2]) % 3 == 0


def inert_bias_ok(got, start, key) -> bool:
    """A BN-fed conv bias moved less than 1e-3 of its conv weight's movement
    (plus 1e-8): what the card's check holds them to."""
    weight = key[: -len("bias")] + "weight"
    moved_w = float((got[weight] - start[weight]).abs().max())
    return float((got[key] - start[key]).abs().max()) <= 1e-3 * moved_w + 1e-8


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference relative to the largest entry; 1e-8 absolute
    is free (the conv biases that feed a BatchNorm: exact gradient 0, both
    sides hold rounding noise near 1e-10)."""
    return float(((got - want).abs().max() - 1e-8).clamp_min(0) / want.abs().max().clamp_min(1e-30))


def jax_momentum(opt_state):
    """The SGD momentum tree (optax's TraceState.trace) of a JAX optimizer
    state: {"det": ..., "dc": ..., ...} like the parameters."""
    found = []
    is_trace = lambda x: type(x).__name__ == "TraceState"  # noqa: E731
    jax.tree_util.tree_map(lambda x: found.append(x.trace) if is_trace(x) else None, opt_state, is_leaf=is_trace)
    assert len(found) == 1
    return found[0]


def load_jax_state(ptr, state, pcfg) -> None:
    """Put a JAX TeacherStudentState into the port's trainer: student,
    teacher, domain classifiers, threshold statistics, SGD momentum, step
    and schedule count."""
    tree = jax.tree_util.tree_map(np.asarray, state)
    w = teacher_student_from_jax(tree, pcfg)
    st = ptr.state
    st.model.load_state_dict(w.student)
    st.teacher.load_state_dict({k: v.to(st.teacher.state_dict()[k].dtype) for k, v in w.teacher.items()})
    for name, module in st.dc.items():
        module.load_state_dict(w.dc[name])
    st.thresh.reserve.copy_(w.thresh["reserve"])
    st.thresh.classwise_acc.copy_(w.thresh["classwise_acc"])
    st.thresh.cursor = w.thresh["cursor"]
    mu = jax_momentum(tree.opt_state)
    # FREEZE_AT's masked optimizer keeps no momentum for frozen leaves (optax MaskedNode)
    masked = lambda x: type(x).__name__ == "MaskedNode"  # noqa: E731
    mu_det = jax.tree_util.tree_map(lambda m, p: np.zeros_like(p) if masked(m) else m, mu["det"], tree.params["det"],
                                    is_leaf=masked)
    named = {f"{k}": v for k, v in state_dict_from_jax({"params": mu_det, "batch_stats": tree.batch_stats}, pcfg).items()}
    for name in st.dc:
        named.update({f"{name}.{k}": v for k, v in dc_state_dict_from_jax(mu[name], name).items()})
    assert set(st.optimizer.names) <= set(named)
    with torch.no_grad():
        for i, name in enumerate(st.optimizer.names):
            st.optimizer.mu[i].copy_(named[name])
    st.step = st.optimizer.count = int(tree.step)


@pytest.mark.parametrize("name", list(CASES))
def test_lockstep_against_jax_sfat_step(tmp_path, monkeypatch, request, name):
    _, _, steps, boosts = CASES[name]
    if "r101" in name:
        from test_torch_adabn import cut_r101

        cut_r101(monkeypatch)
    jtr = jax_build_trainer(case_cfg(jax_get_cfg, tmp_path, name))
    state = jtr.state
    params = dict(state.params)
    teacher_params = boost(state.teacher_params, boosts)
    params["det"] = boost(state.params["det"], boosts, BBOX_OFFSET)
    state = dataclasses.replace(state, params=params, teacher_params=teacher_params)
    jax_step = jax.jit(jtr._step_fn_raw)
    jax_pseudo = jax_pseudo_fn(jtr)

    pcfg_node = case_cfg(get_cfg, tmp_path, name)
    pcfg = detector_config_from_cfg(pcfg_node)
    init = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
    ptr = build_trainer(pcfg_node, device="cpu", weights=init)
    assert type(ptr).__name__ == type(jtr).__name__
    assert ptr.pseudo_from_student == jtr.pseudo_from_student and ptr.ema_enabled == jtr.ema_enabled
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, pcfg.detections_per_image)

    captured = []
    pipeline = ptr.pseudo_pipeline

    def record(dets, step):
        out = pipeline(dets, step)
        captured.append(out[0])
        return out

    ptr.pseudo_pipeline = record
    pseudo_counts, moved, dc_moved = [], 0, 0
    weighted = ptr.dc_image or ptr.dc_instance
    stack = contextlib.ExitStack()
    request.addfinalizer(stack.close)
    masks = stack.enter_context(flax_dropout_masks()) if ptr.dc_instance else []
    jax_step = jax.jit(jtr._step_fn_raw)  # traced (and its masks recorded) inside the context
    for step, batch in enumerate(batches(steps)):
        if step:
            load_jax_state(ptr, state, pcfg)
        start = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
        images, sizes = jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"])
        want_gt = jax_pseudo(state, images, sizes, jtr.base_rng)
        state, jm = jax_step(state, images, sizes, jtr.base_rng)
        jax.effects_barrier()
        assert len(masks) == (4 if ptr.dc_instance else 0)
        want = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
        draws = jax_adapt_draws(jtr.base_rng, step, BATCH, CANVAS, n, pool, bool(pcfg_node.WEAK_STRONG_AUGMENT), masks)
        teacher_before = [t.clone() for t in ema_tensors(ptr.state.teacher)]
        pm = ptr.run_step(batch, draws)

        assert set(pm) == set(jm), sorted(set(pm) ^ set(jm))
        assert_same_pseudo_labels(captured[-1], want_gt)
        assert int(pm["num_pseudo"]) == int(jm["num_pseudo"]) == int(captured[-1].valid.sum()), step
        pseudo_counts.append(int(pm["num_pseudo"]))
        tol = 1e-4 if step < 2 else 1e-3
        for k in LOSSES:
            assert rel_err(float(pm[k]), float(jm[k])) <= tol, (step, k, float(pm[k]), float(jm[k]))
        for k in ("num_fg_pseudo", "num_sampled_pseudo"):
            assert int(pm[k]) == int(jm[k]), (step, k)
        for k in [k for k in jm if k.startswith("loss_DC")]:
            if (ptr.dc_image and "_img_" in k) or (ptr.dc_instance and "_ins_" in k):
                assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4 and float(pm[k]) > 0, (step, k)
            else:
                assert float(pm[k]) == float(jm[k]) == 0.0
        np.testing.assert_allclose(float(pm["pseudo_mean_conf"]), float(jm["pseudo_mean_conf"]), rtol=1e-5)
        th = ptr.state.thresh
        np.testing.assert_array_equal(th.reserve.numpy(), want.thresh["reserve"].numpy())
        np.testing.assert_array_equal(th.classwise_acc.numpy(), want.thresh["classwise_acc"].numpy())
        assert th.cursor == want.thresh["cursor"] == step + 1
        assert ptr.state.step == int(state.step) == step + 1

        # the student and the domain classifiers by the movement-relative rule
        got = ptr.state.model.state_dict()
        bad = [k for k in want.student if not k.endswith("num_batches_tracked")
               and not (inert_bias_ok(got, start.student, k) if bn_fed_bias(k)
                        else within_tolerance(got[k], want.student[k], start.student[k]))]
        assert not bad, (step, bad)
        moved += sum(np.abs((want.student[k] - start.student[k]).numpy()).max() > 1e-3 * np.abs(want.student[k].numpy()).max()
                     for k in want.student)
        for dc_name, module in ptr.state.dc.items():
            for k, v in module.state_dict().items():
                assert within_tolerance(v, want.dc[dc_name][k], start.dc[dc_name][k]), (step, dc_name, k)
                dc_moved += int(not torch.equal(v, init.dc[dc_name][k]))
        # the teacher: parameters fixed, or the EMA of the student's; running
        # statistics moved by its pseudo forward (and blended, with EMA)
        if ptr.ema_enabled:
            # a teacher that makes the pseudo-labels moved its statistics in
            # that forward, before the EMA: only its parameters are checked here
            n_blend = len(teacher_before) if ptr.pseudo_from_student else len(list(ptr.state.teacher.parameters()))
            student_after = ema_tensors(ptr.state.model)
            for t0, t1, s1 in list(zip(teacher_before, ema_tensors(ptr.state.teacher), student_after))[:n_blend]:
                np.testing.assert_allclose(t1.numpy(), (0.99 * t0 + 0.01 * s1).numpy(), rtol=1e-6, atol=1e-7)
        teacher = ptr.state.teacher.state_dict()
        for k, w in want.teacher.items():
            if k.endswith("num_batches_tracked") or k.startswith("pixel_"):
                continue
            if bn_fed_bias(k):
                assert inert_bias_ok(teacher, start.teacher, k), (step, k)
            elif ptr.pseudo_from_student:
                # an EMA of the student's parameters and statistics, which
                # the movement rule holds
                assert within_tolerance(teacher[k], w, start.teacher[k]), (step, k)
            elif k.endswith(("running_mean", "running_var")):
                assert max_rel(teacher[k], w) <= 1e-5, (step, k)
                assert not torch.equal(teacher[k], start.teacher[k]), k  # the pseudo forward moved it
            elif ptr.ema_enabled:
                assert within_tolerance(teacher[k], w, start.teacher[k]), (step, k)
            else:
                assert torch.equal(teacher[k], start.teacher[k]) and torch.equal(teacher[k], w), (step, k)
    assert max(pseudo_counts) > 0
    if name.startswith("a_"):
        # the adaptive branch (from step 1) also takes class 5's detections
        assert pseudo_counts[1] > pseudo_counts[0], pseudo_counts
    if steps > 1:
        assert moved > 50, moved  # the steps moved the weights well beyond the 1e-4 term
    if "r101" in name:  # FREEZE_AT 2: stem and res2 parameters bit-identical, their statistics moved
        got = ptr.state.model.state_dict()
        frozen = [k for k in got if k.startswith(("backbone.stem.", "backbone.res2.")) and not k.endswith("num_batches_tracked")]
        assert frozen and ptr.state.dc["dc"].conv1.weight.shape[1] == 1024
        for k in frozen:
            same = torch.equal(got[k], init.student[k]) and torch.equal(want.student[k], init.student[k])
            assert same != k.endswith(("running_mean", "running_var")), k
    if ptr.state.dc:
        # zero gradients (weight decay and momentum alone move the kernels), or the weighted losses'
        assert dc_moved > 0
    assert weighted == (name[0] in "fghi")


def lockstep_cfg(**overrides):
    cfg = get_cfg()
    cfg.merge_from_list(config_opts(SFAT_BENCH_CONFIG) + config_opts(LOCKSTEP_OPTS))
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    return cfg


@pytest.mark.parametrize(
    "key,value,error,match",
    [
        ("SEMISUPNET.PSEUDO_BBOX_SAMPLE", "'topk'", ValueError, "pseudo label boxes"),
    ],
)
def test_trainer_refuses_unported_settings(key, value, error, match):
    with pytest.raises(error, match=match):
        SourceFreeAdaptiveTeacherTrainer(lockstep_cfg(**{key: value}), device="cpu")


def test_trainer_refuses_a_dis_type_off_the_heads_feature():
    cfg = get_cfg()
    cfg.merge_from_list(config_opts(MAIN_CONFIG) + config_opts(LOCKSTEP_OPTS) + ["SEMISUPNET.DIS_TYPE", "vgg3"])
    with pytest.raises(ValueError, match="DIS_TYPE"):
        build_trainer(cfg, device="cpu")


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SourceFreeAdaptiveTeacherTrainer(lockstep_cfg())


def test_build_trainer_names_the_jax_variants():
    from simple_sfod_tpu_torch.engine.trainers import TRAINER_REGISTRY
    from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer

    build_trainer(lockstep_cfg(TRAINER="source_free_adaptive_teacher"), device="cpu")
    assert {"base", "source_free_adaptive_teacher", "source_free_adaptive_teacher_single",
            "source_free_adaptive_teacher_mosaic"} <= set(TRAINER_REGISTRY)
    assert TRAINER_REGISTRY["base"] is BaseTrainer
    with pytest.raises(ValueError, match="TRAINER"):
        build_trainer(lockstep_cfg(TRAINER="wq"), device="cpu")


def test_trainer_draws_its_own_and_reads_nothing_back():
    """Without draws the trainer makes its own (the same for the same
    seed); the bfloat16 fixed teacher keeps float32 statistics; metrics are
    device tensors without gradients."""
    cfg = lockstep_cfg(**{"TPU.DTYPE": "'bfloat16'"})
    tr = build_trainer(cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tr.state.teacher.parameters())
    assert all(b.dtype == torch.float32 for n, b in tr.state.teacher.named_buffers() if "running" in n)
    assert all(p.dtype == torch.float32 for p in tr.state.model.parameters())
    d = tr.make_draws(BATCH, CANVAS)
    again = build_trainer(cfg, device="cpu").make_draws(BATCH, CANVAS)
    assert torch.equal(d.flip, again.flip) and torch.equal(d.rpn, again.rpn)
    assert all(torch.equal(a, b) for a, b in zip(d.strong, again.strong))
    with torch.no_grad():
        for m in (tr.state.model, tr.state.teacher):
            m.roi_heads.box_predictor.cls_score.bias[1] += 4.0
    teacher0 = {k: v.clone() for k, v in tr.state.teacher.state_dict().items()}
    m = tr.run_step(batches(1)[0])
    assert all(isinstance(v, torch.Tensor) and not v.requires_grad for v in m.values())
    assert all(torch.isfinite(m[k]) for k in LOSSES) and int(m["num_pseudo"]) > 0
    after = tr.state.teacher.state_dict()
    for k, v in teacher0.items():
        if k.endswith(("running_mean", "running_var")):
            assert after[k].dtype == torch.float32
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(after[k], v), k


def test_random_kernels_step_equals_jax_losses_on_its_pseudo_labels(tmp_path):
    """Case a's first step with the random regression kernels of the seeded
    initialisation: the port's pseudo-labels against the JAX pipeline's
    (boxes within 1e-3 px), and the port's losses against the JAX package's
    losses on the port's own pseudo-labels, the JAX strong view and the same
    draws, 1e-4 relative."""
    from simple_sfod_tpu.models.detector import DetectionBatch as JaxBatch
    from simple_sfod_tpu_torch.structures.instances import Instances

    name = "a_main_strong_adaptive"
    jtr = jax_build_trainer(case_cfg(jax_get_cfg, tmp_path, name))
    tree = jax.tree_util.tree_map(np.array, jtr.state.params["det"])
    for k, v in CASES[name][3].items():
        tree["predictor"]["cls_score"]["bias"][k] += v
    params = dict(jtr.state.params, det=jax.tree_util.tree_map(jnp.asarray, tree))
    state = dataclasses.replace(jtr.state, params=params, teacher_params=params["det"])
    pcfg_node = case_cfg(get_cfg, tmp_path, name)
    pcfg = detector_config_from_cfg(pcfg_node)
    ptr = build_trainer(pcfg_node, device="cpu", weights=teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg))
    assert ptr.state.model.proposal_generator.rpn_head.anchor_deltas.weight.abs().max() > 0
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, pcfg.detections_per_image)
    captured = []
    pipeline = ptr.pseudo_pipeline

    def record(dets, step):
        captured.append(pipeline(dets, step))
        return captured[-1]

    ptr.pseudo_pipeline = record

    batch = batches(1)[0]
    images, sizes = jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"])
    want_gt = jax_pseudo_fn(jtr)(state, images, sizes, jtr.base_rng)
    draws = jax_adapt_draws(jtr.base_rng, 0, BATCH, CANVAS, n, pool, True)
    pm = ptr.run_step(batch, draws)
    got_gt = captured[0][0]
    assert_same_pseudo_labels(got_gt, want_gt)

    det = jtr.detector
    rng_flip, rng_strong, rng_loss, _ = jax.random.split(jax.random.fold_in(jtr.base_rng, 0), 4)
    empty = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (BATCH,) + x.shape), JaxInstances.empty(1))

    def losses(variables, images, sizes, gt):
        images_w, _ = jax_apply_weak_aug(rng_flip, images.astype(jnp.float32), sizes, empty, True)
        images_s = jax.vmap(JT.strong_augment)(jax.random.split(rng_strong, BATCH), images_w, sizes)
        feat, _ = det._features(variables, images_s, True, mutable=True)
        return det.losses_from_feature(variables, feat, JaxBatch(images_s, sizes, gt), rng_loss, with_bpc=True)[1]

    gt = JaxInstances(*(jnp.asarray(t.numpy()) for t in (got_gt.boxes, got_gt.scores, got_gt.classes, got_gt.valid)))
    jm = jax.jit(losses)({"params": state.params["det"], "batch_stats": state.batch_stats}, images, sizes, gt)
    for k, v in jm.items():
        assert rel_err(float(pm[f"{k}_pseudo"]), float(v)) <= 1e-4, (k, float(pm[f"{k}_pseudo"]), float(v))
    assert isinstance(got_gt, Instances) and int(pm["num_pseudo"]) > 0


BOOL_DC_YAMLS = ["faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_base.yaml",
                 "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_kq.yaml"]


@pytest.mark.parametrize("yaml", BOOL_DC_YAMLS)
def test_domain_classifier_given_as_bool_builds_and_steps(tmp_path, yaml):
    """The two YAMLs that write `DOMAIN_CLASSIFIER: False` read as ENABLED
    False with IMAGE and INSTANCE off (by file and by KEY VALUE); the SFAT
    trainer builds without domain classifiers and takes a step, cut to the
    lockstep's size. The JAX package replaces the node with the bool, and
    its trainer raises AttributeError on DOMAIN_CLASSIFIER.ENABLED: a fault
    of the reference that the port does not copy."""
    path = os.path.join(os.path.dirname(__file__), "..", "configs", yaml)
    theirs = jax_get_cfg()
    theirs.merge_from_file(path, allow_new=True)
    assert theirs.DOMAIN_CLASSIFIER is False
    with pytest.raises(AttributeError):
        jax_build_trainer(theirs)

    cfg = get_cfg()
    cfg.merge_from_file(path, allow_new=True)
    assert dict(cfg.DOMAIN_CLASSIFIER) == {"ENABLED": False, "IMAGE": False, "INSTANCE": False}
    assert cfg.SEMISUPNET.INS_DC and cfg.TRAINER == "source_free_adaptive_teacher"
    on = get_cfg()
    on.merge_from_list(config_opts(MAIN_CONFIG) + ["DOMAIN_CLASSIFIER", "False"])
    assert dict(on.DOMAIN_CLASSIFIER) == dict(cfg.DOMAIN_CLASSIFIER)
    cfg.merge_from_list(config_opts(LOCKSTEP_OPTS) + ["OUTPUT_DIR", str(tmp_path)])
    tr = build_trainer(cfg, device="cpu")
    assert not tr.dc_enabled and not tr.ins_dc_enabled and not tr.state.dc
    assert tr.weak_strong == (yaml.endswith("_kq.yaml"))
    with torch.no_grad():
        for m in (tr.state.model, tr.state.teacher):
            m.roi_heads.box_predictor.cls_score.bias[1] += 4.0
    m = tr.run_step(batches(1)[0])
    assert all(torch.isfinite(m[k]) for k in LOSSES) and int(m["num_pseudo"]) > 0
    assert not [k for k in m if k.startswith("loss_DC")]
