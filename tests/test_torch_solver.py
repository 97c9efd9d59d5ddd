"""The port's solver (simple_sfod_tpu_torch/solver/build.py) against the
JAX package's on the CPU: schedule values over a grid of steps, the
BatchNorm weight-decay mask and the FREEZE_AT mask key for key through the
Detectron2 names, and parameters after 5 steps on identical gradients
against optax (`SOLVER.FUSED` False and True, clipping on and off).

Tolerances: schedule values exactly equal to the JAX schedule run op by op
(float32 on both sides), and within one float32 ulp of it under jit (XLA
may divide by multiplying with the reciprocal);
parameters 1e-6 of each tensor's largest entry (a fused multiply-add may
round one ulp apart from a multiply and an add)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.solver import build as jax_solver
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN
from simple_sfod_tpu_torch.solver import build as solver

SCHEDULES = {
    "linear": dict(base_lr=0.04, steps=(60, 80, 90, 360), factor_list=(1, 1, 1, 1, 1), warmup_iters=10),
    "linear gamma": dict(base_lr=0.0025, steps=(20, 40), gamma=0.1, warmup_iters=7, warmup_factor=0.001),
    "constant": dict(base_lr=0.01, steps=(5, 30), gamma=0.5, warmup_iters=12, warmup_factor=0.2, warmup_method="constant"),
    "no warmup": dict(base_lr=0.01, steps=(3,), warmup_iters=0),
    "factor padding": dict(base_lr=0.02, steps=(4, 8, 16), factor_list=(1.0, 0.3), warmup_iters=3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_values(name):
    kw = SCHEDULES[name]
    ours = solver.warmup_multistep_schedule(**kw)
    theirs = jax_solver.warmup_multistep_schedule(**kw)
    counts = list(range(0, 40)) + [59, 60, 61, 89, 90, 359, 360, 1000]
    got = np.asarray([ours(c) for c in counts], np.float32)
    want = np.asarray([theirs(jnp.int32(c)) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    jitted = jax.jit(theirs)
    want_jit = np.asarray([jitted(jnp.int32(c)) for c in counts], np.float32)
    ulps = np.abs(got.view(np.int32) - want_jit.view(np.int32))
    assert ulps.max() <= 1, dict(zip(counts, ulps))


def test_schedule_refuses_unknown_warmup():
    with pytest.raises(ValueError, match="WARMUP_METHOD"):
        solver.warmup_multistep_schedule(0.1, (10,), warmup_method="cosine")


OPTS = ["MODEL.BACKBONE.NAME", "build_vgg_backbone", "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)",
        "MODEL.RPN.IN_FEATURES", "('vgg4',)", "MODEL.ROI_HEADS.NUM_CLASSES", "8",
        "MODEL.ROI_BOX_HEAD.FC_DIM", "16", "TPU.CANVAS", "(64, 128)"]


def cfgs(extra=()):
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_list(OPTS + list(extra))
        out.append(c)
    return out


@pytest.fixture(scope="module")
def jax_params():
    """JAX init of the detector at a 64x128 canvas, numpy leaves."""
    _, jcfg = cfgs()
    from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower

    variables = JaxDetector(jax_lower(jcfg)).init(jax.random.key(0), (64, 128))
    return jax.tree_util.tree_map(np.asarray, variables)


def to_port(tree, variables, pcfg):
    """A params-shaped tree (values, a mask or gradients) in the port's
    layout, through the same conversion as the weights."""
    sd = state_dict_from_jax({"params": tree, "batch_stats": variables["batch_stats"]}, pcfg)
    return {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def test_norm_param_mask_key_for_key(jax_params):
    pcfg_node, _ = cfgs()
    pcfg = detector_config_from_cfg(pcfg_node)
    model = FasterRCNN(pcfg)
    jmask = jax_solver.norm_param_mask(jax_params["params"])
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), jmask, jax_params["params"])
    want = {k: bool(v.numpy().all()) for k, v in to_port(as_arrays, jax_params, pcfg).items() if k not in ("pixel_mean", "pixel_std")}
    got = solver.norm_param_mask(model)
    assert got == want
    assert sum(got.values()) == 26 and set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("freeze_at", [0, 2, 5])
def test_freeze_mask_selects_nothing_on_vgg(jax_params, freeze_at):
    pcfg_node, _ = cfgs()
    model = FasterRCNN(detector_config_from_cfg(pcfg_node))
    jmask = jax_solver.backbone_freeze_mask(jax_params["params"], freeze_at)
    assert not any(jax.tree_util.tree_leaves(jmask))
    got = solver.backbone_freeze_mask(model, freeze_at)
    assert not any(got.values()) and set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["SOLVER.FUSED", "True", "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.05",
         "SOLVER.WEIGHT_DECAY_NORM", "0.001"],
        ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.05",
         "SOLVER.WEIGHT_DECAY_NORM", "0.001", "SOLVER.MOMENTUM", "0.8"],
    ],
    ids=["optax", "fused-clip-wdnorm", "optax-clip-wdnorm"],
)
def test_five_steps_on_identical_gradients(jax_params, extra):
    extra = ["SOLVER.BASE_LR", "0.05", "SOLVER.WARMUP_ITERS", "3", "SOLVER.STEPS", "(4,)", "SOLVER.WEIGHT_DECAY", "0.01"] + extra
    pcfg_node, jcfg_node = cfgs(extra)
    pcfg = detector_config_from_cfg(pcfg_node)
    params = jax_params["params"]
    model = FasterRCNN(pcfg)
    model.load_state_dict(state_dict_from_jax(jax_params, pcfg), strict=True)
    named = dict(model.named_parameters())
    opt = solver.build_optimizer(pcfg_node, model)

    tx = jax_solver.build_optimizer(jcfg_node)
    opt_state = tx.init(params)
    step = jax.jit(lambda g, s, p: jax_solver.apply_gradients(tx, g, s, p))
    rs = np.random.RandomState(len(extra))
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda p: rs.normal(0, 0.1, p.shape).astype(np.float32), params)
        params, opt_state = step(grads, opt_state, params)
        for name, g in to_port(grads, jax_params, pcfg).items():
            if name in named:
                named[name].grad = g.clone()
        opt.step()
    assert opt.count == 5
    want = to_port(jax.tree_util.tree_map(np.asarray, params), jax_params, pcfg)
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=name)
