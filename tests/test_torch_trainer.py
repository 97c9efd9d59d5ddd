"""The port's supervised trainer against the JAX package's, step for step,
on the CPU in float32; and the configuration and refusals around it.

The lockstep builds the JAX `BaseTrainer` itself (its constructor needs no
dataset) and runs its raw step function, `_step_fn_raw`, under jit for 3
steps; the port's `BaseTrainer.run_step` starts from the same weights
(checkpoint/from_jax.py) and gets the JAX step's own draws: the flip
bernoullis and both samplers' uniform priorities, extracted from the JAX
key schedule fold_in(rng, step) -> split -> (aug, loss). VGG16-BN at a
64x128 canvas, FC_DIM 64, an RPN batch of 64 and an ROI batch of 32 (real sampling: both
pools hold more candidates than the batch takes), warmup inside the 3 steps.

Tolerances: the fg/sampled counts equal at every step; each loss 1e-4
relative at steps 1 and 2 and 1e-3 at step 3; after step 3 each parameter
and BatchNorm statistic within 1e-4 of its tensor's largest entry plus 25%
of how far the three steps moved the tensor, plus 1e-8 absolute. Why the
25%: at identical weights the two packages' backbone gradients already
differ by up to about a fifth of a tensor's largest entry at this size
(test_torch_train_model.py::test_supervised_gradients_on_jax_draws bounds
them at 25%: ReLUs that flip sign on rounding on small feature maps, and
flax's inexact float32 BatchNorm gradient, pinned by
test_bn_gradient_against_float64), so the updates differ as much. The 1e-8 covers the conv biases that feed a BatchNorm:
their exact gradient is 0 and both sides hold rounding noise near 1e-10.
Semantic faults (sampling, matching, flip, BatchNorm bookkeeping, the
update rule) move the losses far beyond these bounds; the solver alone is
held to 1e-6 in test_torch_solver.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers.base import BaseTrainer as JaxBaseTrainer
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import SOURCE_CONFIG, detector_config_from_cfg, get_cfg, get_source_cfg
from simple_sfod_tpu_torch.config.defaults import SOURCE_CONFIG_NAME, config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer, Draws
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from test_torch_train_model import jax_loss_draws

CANVAS = (64, 128)
GT_CAP = 8
BATCH = 2
STEPS = 3
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
LOCKSTEP_OPTS = {
    "TPU": {"CANVAS": CANVAS, "GT_CAPACITY": GT_CAP, "MESH_DATA": 1},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 64},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 32}},
    "SOLVER": {"IMS_PER_BATCH": BATCH, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
}


def lockstep_cfg(get, tmp_path):
    cfg = get()
    cfg.merge_from_list(config_opts(SOURCE_CONFIG) + config_opts(LOCKSTEP_OPTS))
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def jax_step_draws(base_rng, step, batch_size, num_anchors, pool):
    """The draws of the JAX base trainer's step `step`."""
    rng = jax.random.fold_in(base_rng, step)
    rng_aug, rng_loss = jax.random.split(rng)
    flip = np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(rng_aug, batch_size)])
    rpn, roi = jax_loss_draws(rng_loss, batch_size, num_anchors, pool)
    return Draws(*(torch.from_numpy(np.array(a)) for a in (flip, rpn, roi)))


def rel_err(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def within_tolerance(got: torch.Tensor, want: torch.Tensor, init: torch.Tensor) -> bool:
    w = want.numpy().astype(np.float64)
    err = np.abs(got.detach().numpy() - w).max()
    return err <= 1e-4 * np.abs(w).max() + 0.25 * np.abs(w - init.numpy()).max() + 1e-8


def test_lockstep_three_steps_against_jax_base_trainer(tmp_path):
    jtr = JaxBaseTrainer(lockstep_cfg(jax_get_cfg, tmp_path))
    jax_step = jax.jit(jtr._step_fn_raw)
    pcfg_node = lockstep_cfg(get_cfg, tmp_path)
    pcfg = detector_config_from_cfg(pcfg_node)
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    ptr = BaseTrainer(pcfg_node, device="cpu", state_dict=state_dict_from_jax(init, pcfg))

    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_CAP)
    records = make_synthetic_records(BATCH * STEPS, (60, 120), 8, 6, seed=3)
    state = jtr.state
    flips = []
    for step in range(STEPS):
        batch = synthetic_batch(records[step * BATCH:(step + 1) * BATCH], CANVAS, GT_CAP)
        state, jm = jax_step(state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]), jax_gt_instances(batch), jtr.base_rng)
        draws = jax_step_draws(jtr.base_rng, step, BATCH, n, pool)
        flips += draws.flip.tolist()
        pm = ptr.run_step(batch, draws)
        tol = 1e-4 if step < 2 else 1e-3
        for k in LOSSES:
            assert rel_err(float(pm[k]), float(jm[k])) <= tol, (step, k, float(pm[k]), float(jm[k]))
        for k in ("num_fg", "num_sampled"):
            assert int(pm[k]) == int(jm[k]), (step, k)
        # real sampling: fewer samples than candidates, some of them foreground
        assert 0 < int(pm["num_fg"]) and int(pm["num_sampled"]) == BATCH * pcfg.roi_batch_size_per_image
    assert any(flips) and not all(flips)
    assert ptr.state.step == STEPS == int(state.step) and ptr.state.optimizer.count == STEPS

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    start = state_dict_from_jax(init, pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    # the steps moved the weights and statistics well beyond the 1e-4 term
    moved = [k for k in want if np.abs((want[k] - start[k]).numpy()).max() > 1e-3 * np.abs(want[k].numpy()).max()]
    assert len(moved) > 50


def test_trainer_draws_its_own_and_returns_device_tensors(tmp_path):
    cfg = lockstep_cfg(get_cfg, tmp_path)
    tr = BaseTrainer(cfg, device="cpu")
    batch = synthetic_batch(make_synthetic_records(BATCH, (60, 120), 8, 6, seed=1), CANVAS, GT_CAP)
    d = tr.make_draws(BATCH, CANVAS, GT_CAP)
    n = anchors_for(tr.det_cfg, CANVAS, torch.device("cpu")).shape[0]
    assert d.flip.dtype == torch.bool and d.rpn.shape == (BATCH, n)
    assert d.roi.shape == (BATCH, roi_pool_size(tr.det_cfg, n, GT_CAP))
    # the same seed draws the same sequence; no box-head keep masks without dropout
    again = BaseTrainer(cfg, device="cpu").make_draws(BATCH, CANVAS, GT_CAP)
    assert d.box_keep is None and again.box_keep is None
    assert all(torch.equal(a, b) for a, b in zip(d[:3], again[:3]))
    m = tr.run_step(batch)
    assert set(m) == set(LOSSES) | {"num_fg", "num_sampled"}
    assert all(isinstance(v, torch.Tensor) and not v.requires_grad for v in m.values())
    assert all(torch.isfinite(m[k]) for k in LOSSES)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BaseTrainer(get_source_cfg())


def test_trainer_refuses_vertical_flip():
    cfg = get_source_cfg()
    cfg.INPUT.RANDOM_FLIP = "vertical"
    with pytest.raises(ValueError, match="RANDOM_FLIP"):
        BaseTrainer(cfg, device="cpu")


def test_source_config_from_python_keys_equals_yaml():
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "configs", SOURCE_CONFIG_NAME)
    from_yaml, theirs = get_cfg(), jax_get_cfg()
    from_yaml.merge_from_file(path)
    theirs.merge_from_file(path)

    def plain(node):
        return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}

    assert plain(get_source_cfg()) == plain(from_yaml) == plain(theirs)
    ours, want = dataclasses.asdict(detector_config_from_cfg(get_source_cfg())), dataclasses.asdict(jax_lower(theirs))
    assert ours.pop("dtype") == torch.float32 and want.pop("dtype") == jnp.float32
    assert ours == want
    assert ours["rpn_pre_nms_topk_train"] == 4096 and ours["rpn_post_nms_topk_train"] == 2000
    assert get_source_cfg().TRAINER == "base" and get_source_cfg().SOLVER.IMS_PER_BATCH == 1


R101_SOURCE_YAML = "r_101_c4_cs_source_frozen.yaml"
R101_LOCKSTEP_OPTS = {
    **LOCKSTEP_OPTS,
    "TPU": {**LOCKSTEP_OPTS["TPU"], "DTYPE": "float32"},
    "INPUT": {"MIN_SIZE_TRAIN": (60,)},
}


@pytest.mark.parametrize("norm", ["FrozenBN", "BN"])
def test_lockstep_resnet101_base_step_against_jax(tmp_path, monkeypatch, norm):
    """Two base steps of configs/r_101_c4_cs_source_frozen.yaml (FREEZE_AT
    2; NORM FrozenBN as the YAML says, and BN) on a cut block plan, float32,
    against the JAX BaseTrainer's _step_fn_raw on its draws, from the same
    weights with random statistics; the lockstep's tolerances above. The
    stem and res2 parameters are bit-identical after the steps in both
    packages and the port ran no backward through them (no gradient, none
    required); FrozenBN buffers are bit-identical. Under BN the stem's and
    res2's running statistics move in both packages: the JAX package
    freezes only their parameters, where Detectron2 would have converted
    those layers to FrozenBN (a deviation from Detectron2, followed)."""
    import os

    from test_torch_adabn import cut_r101

    cut_r101(monkeypatch)
    yaml = os.path.join(os.path.dirname(__file__), "..", "configs", R101_SOURCE_YAML)
    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(config_opts(R101_LOCKSTEP_OPTS) + ["MODEL.RESNETS.NORM", norm])
        cfg.OUTPUT_DIR = str(tmp_path)
        cfgs.append(cfg)
    jtr = JaxBaseTrainer(cfgs[0])
    rs = np.random.RandomState(9)
    jtr.state = jtr.state.replace(batch_stats=jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.normal(0, 0.1, x.shape) if str(path[-1].key) == "mean" else rs.uniform(0.5, 2.0, x.shape))
        .astype(np.float32), jtr.state.batch_stats))
    jax_step = jax.jit(jtr._step_fn_raw)
    pcfg = detector_config_from_cfg(cfgs[1])
    assert pcfg.backbone == "resnet101" and pcfg.resnet_norm == norm
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    start = state_dict_from_jax(init, pcfg)
    ptr = BaseTrainer(cfgs[1], device="cpu", state_dict=start)
    frozen = {n for n, p in ptr.state.model.named_parameters() if n.startswith(("backbone.stem.", "backbone.res2."))}
    assert frozen and all(not p.requires_grad for n, p in ptr.state.model.named_parameters() if n in frozen)
    assert not frozen & set(ptr.state.optimizer.names)

    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_CAP)
    records = make_synthetic_records(BATCH * 2, (60, 120), 8, 6, seed=5)
    state = jtr.state
    for step in range(2):
        batch = synthetic_batch(records[step * BATCH:(step + 1) * BATCH], CANVAS, GT_CAP)
        state, jm = jax_step(state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]), jax_gt_instances(batch), jtr.base_rng)
        pm = ptr.run_step(batch, jax_step_draws(jtr.base_rng, step, BATCH, n, pool))
        for k in LOSSES:
            assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (step, k, float(pm[k]), float(jm[k]))
        for k in ("num_fg", "num_sampled"):
            assert int(pm[k]) == int(jm[k]), (step, k)
    assert all(p.grad is None for n, p in ptr.state.model.named_parameters() if n in frozen)

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    stem_res2 = [k for k in want if k.startswith(("backbone.stem.", "backbone.res2.")) and not k.endswith("num_batches_tracked")]
    for k in stem_res2:
        stat = k.endswith(("running_mean", "running_var"))
        if stat and norm == "BN":  # moved by the train-mode forwards, in both packages
            assert not torch.equal(got[k], start[k]) and not torch.equal(want[k], start[k]), k
        else:  # frozen parameters and FrozenBN buffers: bit-identical in both
            assert torch.equal(got[k], start[k]) and torch.equal(want[k], start[k]), k
    if norm == "FrozenBN":
        buffers = [k for k in got if ".norm." in k and not k.endswith("num_batches_tracked")]
        assert buffers and all(torch.equal(got[k], start[k]) for k in buffers)
    moved = [k for k in want if np.abs((want[k] - start[k]).numpy()).max() > 1e-3 * np.abs(want[k].numpy()).max()]
    assert len(moved) > 20
