"""The port's domain-adversarial pieces against the JAX package's, on the
CPU in float32: gradient reversal, the DA heads, `dc_losses`, the box-head
features of the training proposals, and the `da`/`cda` trainers step for
step; their weights crossing, resume, STEPS_PER_DISPATCH and CLI.

Dropout masks are flax's own: test_torch_sfat_trainer.py:flax_dropout_masks
records each mask that flax's Dropout draws, so the port's instance head
runs on the very bits the JAX step used. Nothing of the JAX package
changes.

Tolerances, stated with each test:
  GRL                           1e-7 absolute (exact in practice)
  heads (both modes)            1e-5 of the output's largest entry
  dc_losses                     values 2e-5 relative; gradients of each loss
                                with respect to the feature, the detector's
                                parameters and both heads 2e-4 of the
                                tensor's largest entry (+1e-10); the RPN's
                                gradient exactly 0 on both sides
  box_features_from_feature     1e-5 of the largest entry; valid equal
  trainer lockstep              test_torch_sfat_trainer.py's rules: each
                                loss 1e-4 relative, counts equal, each
                                parameter and statistic within 1e-4 of its
                                largest entry plus 25% of the step's
                                movement (BN-fed conv biases by their rule)

The lockstep: VGG16-BN at a 64x128 canvas with 60x120 images, batch 2 + 2,
FC_DIM 64, take-all ROI sampling; each step starts from the JAX state and
takes the JAX step's draws (key schedule fold_in(rng, step) -> split 5 ->
(flip, sup, dc_s, dc_t, flip_t)) and flax's masks.
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
from simple_sfod_tpu.engine.trainers.da import dc_losses as jax_dc_losses
from simple_sfod_tpu.models import dann as jax_dann
from simple_sfod_tpu_torch.checkpoint.from_jax import da_state_from_jax, dc_state_dict_from_jax, state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.da import CDATrainer, DADraws, DATrainer, dc_losses
from simple_sfod_tpu_torch.models import dann
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from test_torch_sfat_trainer import bn_fed_bias, flax_dropout_masks, inert_bias_ok, jax_momentum
from test_torch_train_model import jax_loss_draws
from test_torch_trainer import rel_err, within_tolerance

ROOT = os.path.join(os.path.dirname(__file__), "..")
DA_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_cityscapes_da.yaml")
CANVAS = (64, 128)
IMAGE_HW = (60, 120)
BATCH = 2
GT_CAP = 8
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_DC_img", "loss_DC_ins",
          "loss_consistency", "total_loss")
OPTS = {
    "TPU": {"CANVAS": CANVAS, "GT_CAPACITY": GT_CAP, "MESH_DATA": 1, "DTYPE": "float32"},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}, "RPN": {"BATCH_SIZE_PER_IMAGE": 256},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 256, "POSITIVE_FRACTION": 1.0}},
    "SOLVER": {"IMS_PER_BATCH": BATCH, "IMS_PER_BATCH_TARGET": BATCH, "BASE_LR": 0.01, "WARMUP_ITERS": 2},
}
W_IMG, W_INS, W_CST = 0.3, 0.7, 0.4  # dc_losses' GRL scales: distinct, so each path shows


@pytest.fixture(autouse=True)
def two_threads(tmp_path):
    """Each test on 2 torch threads; its directory removed after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    shutil.rmtree(tmp_path, ignore_errors=True)


def da_cfg(get, tmp_path, trainer="da", *opts):
    cfg = get()
    cfg.merge_from_file(DA_YAML)
    cfg.merge_from_list(config_opts(OPTS) + ["TRAINER", trainer, *opts])
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def max_rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


# ------------------------------------------------------------------ GRL, heads
@pytest.mark.parametrize("alpha", [-0.3, 1.7])
def test_gradient_scalar_against_jax(alpha):
    """Identity forward, the gradient times alpha: 1e-7 absolute."""
    rs = np.random.RandomState(0)
    x, w = rs.standard_normal((3, 5)).astype(np.float32), rs.standard_normal((3, 5)).astype(np.float32)
    y, g = jax.value_and_grad(lambda v: jnp.sum(jax_dann.gradient_scalar(v, alpha) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = dann.gradient_scalar(xt, alpha)
    assert torch.equal(out, xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=0, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), alpha * w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("which", ["img", "ins_eval", "ins_train"])
def test_da_heads_against_flax(which):
    """DAImgHead and DAInsHead (eval, and train on flax's dropout masks)
    from the same flax parameters: 1e-5 of the output's largest entry."""
    rs = np.random.RandomState(1)
    if which == "img":
        jmod, pmod, name = jax_dann.DAImgHead(), dann.DAImgHead(32), "da_img"
        x = rs.standard_normal((2, 4, 8, 32)).astype(np.float32)
        params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
        pmod.load_state_dict(dc_state_dict_from_jax(params, name))
        got = pmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    else:
        jmod, pmod, name = jax_dann.DAInsHead(), dann.DAInsHead(48), "da_ins"
        x = rs.standard_normal((6, 48)).astype(np.float32)
        params = jmod.init(jax.random.key(0), jnp.asarray(x), train=False)["params"]
        pmod.load_state_dict(dc_state_dict_from_jax(params, name))
        if which == "ins_eval":
            want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), train=False))
            got = pmod(torch.from_numpy(x))
        else:
            with flax_dropout_masks() as masks:
                want = np.asarray(jax.jit(lambda p, v, k: jmod.apply({"params": p}, v, train=True, rngs={"dropout": k}))(
                    params, jnp.asarray(x), jax.random.key(3)))
                jax.effects_barrier()
            assert len(masks) == 2 and all(m.shape == (6, 1024) for m in masks)
            assert 0.3 < masks[0].mean() < 0.7
            got = pmod(torch.from_numpy(x), [torch.from_numpy(m.copy()) for m in masks])
            assert not np.allclose(want, np.asarray(jmod.apply({"params": params}, jnp.asarray(x), train=False)))
    assert max_rel_err(got.detach().numpy(), want) <= 1e-5


def test_init_dc_weights_scales():
    """DAImgHead's kernels at normal(0.001), DAInsHead's at normal(0.01),
    zero biases; the same seed gives the same weights."""
    img = dann.init_dc_weights(dann.DAImgHead(512), 3)
    ins = dann.init_dc_weights(dann.DAInsHead(64), 3)
    assert 0.0008 < float(img.conv1.weight.detach().std()) < 0.0012 and 0.0005 < float(img.conv2.weight.detach().std()) < 0.0015
    assert 0.008 < float(ins.fc2.weight.detach().std()) < 0.012
    assert all(float(m.bias.abs().max()) == 0 for m in (img.conv1, img.conv2, ins.fc1, ins.fc3))
    again = dann.init_dc_weights(dann.DAImgHead(512), 3)
    assert all(torch.equal(a, b) for a, b in zip(img.state_dict().values(), again.state_dict().values()))


# ------------------------------------------------------------------ dc_losses
def seeded_setup(conditional: bool, seed: int = 0):
    """The JAX detector (a DA trainer's, at the lockstep's size) and the
    port's on seeded weights (jax.eval_shape of the init, seeded fills at the
    initialisers' scales), both DA heads, and a seeded feature."""
    from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
    from simple_sfod_tpu.models.detector import Detector as JaxDetector
    from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN

    jcfg = jax_lower(da_cfg(jax_get_cfg, "/nonexistent"))
    pcfg = detector_config_from_cfg(da_cfg(get_cfg, "/nonexistent"))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] == "kernel":
            std = 0.01 if ("rpn_head" in keys or "cls_score" in keys) else 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rs.normal(0, std, leaf.shape).astype(np.float32)
        if keys[-1] in ("scale", "var"):
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rs.normal(0, 0.05, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(lambda: JaxFasterRCNN(jcfg).init(jax.random.key(0), jnp.zeros((1, *CANVAS, 3))))
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    c = pcfg.feature_channels
    fh, fw = CANVAS[0] // pcfg.stride, CANVAS[1] // pcfg.stride
    ins_dim = pcfg.fc_dim * ((pcfg.num_classes + 1) if conditional else 1)
    heads = {
        "da_img": jax_dann.DAImgHead().init(jax.random.key(1), jnp.zeros((1, fh, fw, c)))["params"],
        "da_ins": jax_dann.DAInsHead().init(jax.random.key(2), jnp.zeros((1, ins_dim)), train=False)["params"],
    }
    heads = jax.tree_util.tree_map(lambda x: rs.normal(0, 0.05, x.shape).astype(np.float32), heads)
    feature = rs.standard_normal((BATCH, fh, fw, c)).astype(np.float32)
    pdet = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    phead = {"da_img": dann.DAImgHead(c), "da_ins": dann.DAInsHead(ins_dim)}
    for name, m in phead.items():
        m.load_state_dict(dc_state_dict_from_jax(heads[name], name))
    return JaxDetector(jcfg), variables, heads, feature, pdet, phead, pcfg


@pytest.mark.parametrize("conditional,entropy", [(False, False), (True, False), (True, True)],
                         ids=["da", "cda", "cda_entropy"])
@pytest.mark.parametrize("domain", [0.0, 1.0], ids=["source", "target"])
def test_dc_losses_against_jax(conditional, entropy, domain):
    """The three losses and, for each, its gradient with respect to the
    feature, the detector's parameters, da_img and da_ins, on flax's
    dropout masks: values 2e-5 relative, gradients 2e-4 of each tensor's
    largest entry (+1e-10). The GRL signs and scales show in the
    gradients; the RPN's gradient is exactly 0 (the boxes are detached)."""
    jdet, variables, heads, feature, pdet, phead, pcfg = seeded_setup(conditional)
    sizes = np.tile(np.int32(IMAGE_HW), (BATCH, 1))

    def losses(feat, params):
        return jax_dc_losses(
            jdet, params, {"params": params["det"], "batch_stats": variables["batch_stats"]}, feat, CANVAS,
            jnp.asarray(sizes), domain, jax.random.key(9), w_img=W_IMG, w_ins=W_INS, w_cst=W_CST,
            conditional=conditional, entropy_conditioning=entropy, da_img_head=jax_dann.DAImgHead(),
            da_ins_head=jax_dann.DAInsHead(),
        )

    def with_vjps(feat, params):
        out, vjp = jax.vjp(losses, feat, params)
        eye = [tuple(jnp.float32(i == j) for j in range(3)) for i in range(3)]
        return out, [vjp(e) for e in eye]

    params = {"det": variables["params"], **heads}
    with flax_dropout_masks() as masks:
        want, grads = jax.jit(with_vjps)(jnp.asarray(feature), params)
        jax.effects_barrier()
    assert len(masks) == 4  # the instance call's two, the consistency call's two

    feat = torch.from_numpy(feature.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = dc_losses(pdet, phead["da_img"], phead["da_ins"], feat, CANVAS, torch.from_numpy(sizes), domain,
                    [torch.from_numpy(m.copy()) for m in masks], w_img=W_IMG, w_ins=W_INS, w_cst=W_CST,
                    conditional=conditional, entropy_conditioning=entropy)
    for name, g, w in zip(("img", "ins", "cst"), got, want):
        assert rel_err(g.item(), float(w)) <= 2e-5, (name, g.item(), float(w))

    det_params = dict(pdet.model.named_parameters())
    head_params = {f"{h}.{k}": p for h, m in phead.items() for k, p in m.named_parameters()}
    tensors = [feat] + list(det_params.values()) + list(head_params.values())
    zero_stats = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    for i, (name, loss) in enumerate(zip(("img", "ins", "cst"), got)):
        gfeat, gparams = grads[i]
        pg = torch.autograd.grad(loss, tensors, retain_graph=True, allow_unused=True)
        pg = [torch.zeros_like(x) if g is None else g for x, g in zip(tensors, pg)]
        jg = {"feature": np.asarray(gfeat).transpose(0, 3, 1, 2)}
        jg.update({k: v.numpy() for k, v in state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, gparams["det"]), "batch_stats": zero_stats}, pcfg).items()})
        for h in ("da_img", "da_ins"):
            jg.update({f"{h}.{k}": v.numpy() for k, v in dc_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, gparams[h]), h).items()})
        names = ["feature"] + list(det_params) + list(head_params)
        for n, g in zip(names, pg):
            w = jg[n]
            err = np.abs(g.numpy() - w).max()
            assert err <= 2e-4 * np.abs(w).max() + 1e-10, (name, n, err, np.abs(w).max())
        for n in ("proposal_generator.rpn_head.conv.weight", "proposal_generator.rpn_head.objectness_logits.weight"):
            assert float(np.abs(jg[n]).max()) == 0.0 and float(pg[names.index(n)].abs().max()) == 0.0
    # the reversal: the image loss pushes the feature against its own descent
    assert float(np.abs(np.asarray(grads[0][0])).max()) > 0


def test_box_features_from_feature_against_jax():
    """Box-head features of the training proposals and their valid mask:
    1e-5 of the largest entry; valid equal; one launch of each NMS path
    a image (propose)."""
    jdet, variables, _, feature, pdet, _, _ = seeded_setup(False, seed=4)
    sizes = np.asarray([IMAGE_HW, (40, 100)], np.int32)
    wf, wv = jax.jit(lambda v, f: jdet.box_features_from_feature(v, f, jnp.asarray(sizes), CANVAS))(
        variables, jnp.asarray(feature))
    gf, gv = pdet.box_features_from_feature(torch.from_numpy(feature.transpose(0, 3, 1, 2).copy()),
                                            torch.from_numpy(sizes), CANVAS)
    assert gf.shape == wf.shape and gf.shape[1] == 64
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < int(gv.sum()) < gv.numel()
    assert max_rel_err(gf.detach().numpy(), wf) <= 1e-5


# ------------------------------------------------------------------ trainers
def batches(steps, seed=3):
    """(source with GT, target) batch pairs at the lockstep's size."""
    recs = make_synthetic_records(2 * BATCH * steps, IMAGE_HW, 8, 6, seed=seed)
    return [(synthetic_batch(recs[2 * i * BATCH:(2 * i + 1) * BATCH], CANVAS, GT_CAP),
             synthetic_batch(recs[(2 * i + 1) * BATCH:(2 * i + 2) * BATCH], CANVAS, GT_CAP)) for i in range(steps)]


def jax_da_draws(base_rng, step, num_anchors, pool, masks):
    """The draws of the JAX DA step `step` with flax's 8 masks of it."""
    rng = jax.random.fold_in(base_rng, step)
    k_flip, k_sup, _, _, k_flip_t = jax.random.split(rng, 5)
    flip = [np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(key, BATCH)]) for key in (k_flip, k_flip_t)]
    rpn, roi = jax_loss_draws(k_sup, BATCH, num_anchors, pool)
    m = [torch.from_numpy(x.copy()) for x in masks]
    return DADraws(t(flip[0]), t(rpn), t(roi), t(flip[1]), tuple(m[:4]), tuple(m[4:8]))


def load_jax_da_state(ptr, state, pcfg) -> None:
    """A JAX DA TrainState into the port's trainer: detector, heads,
    momentum, step and schedule count."""
    tree = jax.tree_util.tree_map(np.asarray, state)
    w = da_state_from_jax(tree, pcfg)
    st = ptr.state
    st.model.load_state_dict(w.detector)
    for name, m in st.heads.items():
        m.load_state_dict(w.heads[name])
    mu = jax_momentum(tree.opt_state)
    named = dict(state_dict_from_jax({"params": mu["det"], "batch_stats": tree.batch_stats}, pcfg))
    for name in st.heads:
        named.update({f"{name}.{k}": v for k, v in dc_state_dict_from_jax(mu[name], name).items()})
    with torch.no_grad():
        for i, name in enumerate(st.optimizer.names):
            st.optimizer.mu[i].copy_(named[name])
    st.step = st.optimizer.count = int(tree.step)


@pytest.mark.parametrize("trainer,opts", [("da", ()), ("cda", ("DA_FASTER.ENTROPY_CONDITIONING", "True"))],
                         ids=["da", "cda_entropy"])
def test_lockstep_against_jax_da_step(tmp_path, trainer, opts):
    """2 steps of the JAX DATrainer/CDATrainer._step_fn_raw and the port's,
    each from the JAX state, on the JAX draws and flax's masks (rules in the
    module docstring)."""
    jtr = jax_build_trainer(da_cfg(jax_get_cfg, tmp_path, trainer, *opts))
    pcfg_node = da_cfg(get_cfg, tmp_path, trainer, *opts)
    pcfg = detector_config_from_cfg(pcfg_node)
    ptr = build_trainer(pcfg_node, device="cpu", weights=da_state_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state), pcfg))
    assert type(ptr).__name__ == type(jtr).__name__ and ptr.entropy_conditioning == bool(opts)
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_CAP)
    state = jtr.state
    with flax_dropout_masks() as masks:
        jax_step = jax.jit(jtr._step_fn_raw)
        moved = 0
        for step, (src, tgt) in enumerate(batches(2)):
            if step:
                load_jax_da_state(ptr, state, pcfg)
            start = da_state_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
            state, jm = jax_step(state, jnp.asarray(src["images"]), jnp.asarray(src["sizes"]), jax_gt_instances(src),
                                 jnp.asarray(tgt["images"]), jnp.asarray(tgt["sizes"]), jtr.base_rng)
            jax.effects_barrier()
            assert len(masks) == 8
            want = da_state_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
            pm = ptr.run_step(src, jax_da_draws(jtr.base_rng, step, n, pool, masks), target=tgt)
            assert set(pm) == set(jm), sorted(set(pm) ^ set(jm))
            for k in LOSSES:
                assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (step, k, float(pm[k]), float(jm[k]))
            for k in ("num_fg", "num_sampled"):
                assert int(pm[k]) == int(jm[k]), (step, k)
            got = ptr.state.model.state_dict()
            bad = [k for k in want.detector if not k.endswith("num_batches_tracked")
                   and not (inert_bias_ok(got, start.detector, k) if bn_fed_bias(k)
                            else within_tolerance(got[k], want.detector[k], start.detector[k]))]
            assert not bad, (step, bad)
            for name, m in ptr.state.heads.items():
                for k, v in m.state_dict().items():
                    assert within_tolerance(v, want.heads[name][k], start.heads[name][k]), (step, name, k)
                    moved += int(not torch.equal(v, start.heads[name][k]))
            assert ptr.state.step == int(state.step) == step + 1
    assert moved >= 8  # every head tensor moved


def test_da_refuses_entropy_conditioning_as_jax(tmp_path):
    """DA_FASTER.ENTROPY_CONDITIONING on `da` is refused with the JAX
    package's message; `cda` takes it."""
    with pytest.raises(ValueError) as want:
        jax_build_trainer(da_cfg(jax_get_cfg, tmp_path, "da", "DA_FASTER.ENTROPY_CONDITIONING", "True"))
    with pytest.raises(ValueError) as got:
        build_trainer(da_cfg(get_cfg, tmp_path, "da", "DA_FASTER.ENTROPY_CONDITIONING", "True"), device="cpu")
    assert str(got.value) == str(want.value)
    tr = build_trainer(da_cfg(get_cfg, tmp_path, "cda", "DA_FASTER.ENTROPY_CONDITIONING", "True"), device="cpu")
    assert isinstance(tr, CDATrainer) and tr.state.heads["da_ins"].fc1.in_features == 64 * 9


def test_from_jax_da_state_key_for_key(tmp_path):
    """da_state_from_jax of a JAX DA state: the port trainer's detector and
    head keys exactly, every value equal to the flax leaf it came from."""
    jtr = jax_build_trainer(da_cfg(jax_get_cfg, tmp_path, "cda"))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state)
    pcfg_node = da_cfg(get_cfg, tmp_path, "cda")
    w = da_state_from_jax(tree, detector_config_from_cfg(pcfg_node))
    ptr = build_trainer(pcfg_node, device="cpu", weights=w)
    assert set(w.detector) == set(ptr.state.model.state_dict())
    for name, m in ptr.state.heads.items():
        assert list(w.heads[name]) == list(m.state_dict())
        for layer in dict.fromkeys(k.split(".")[0] for k in w.heads[name]):
            kernel = tree.params[name][layer]["kernel"]
            want = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
            np.testing.assert_array_equal(w.heads[name][f"{layer}.weight"].numpy(), want)
            np.testing.assert_array_equal(m.state_dict()[f"{layer}.bias"].numpy(), tree.params[name][layer]["bias"])
    assert ptr.state.heads["da_img"].conv1.weight.shape == (512, 512, 1, 1)
    assert set(ptr.state.optimizer.names) == {k for k, _ in ptr.state.model.named_parameters()} | {
        f"{h}.{k}" for h in w.heads for k in w.heads[h]}


class RepeatPair:
    """A train loader that yields one batch forever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def small_da(tmp_path, trainer="da", *opts):
    cfg = da_cfg(get_cfg, tmp_path, trainer, "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
                 "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", *opts)
    tr = build_trainer(cfg, device="cpu")
    src, tgt = (synthetic_batch([r], CANVAS, GT_CAP) for r in make_synthetic_records(2, IMAGE_HW, 8, 6, seed=5))
    tr.train_loader = RepeatPair(src)
    tr._build_target_loader = lambda: RepeatPair(tgt)
    return tr


def states_equal(a, b) -> bool:
    sa, sb = a.checkpoint_state(), b.checkpoint_state()
    flat = lambda d: {f"{h}.{k}": v for h, m in d["trainer"]["heads"].items() for k, v in m.items()}  # noqa: E731
    return (all(torch.equal(v, sb["model"][k]) for k, v in sa["model"].items())
            and all(torch.equal(v, flat(sb)[k]) for k, v in flat(sa).items())
            and all(torch.equal(v, sb["optimizer"]["mu"][k]) for k, v in sa["optimizer"]["mu"].items())
            and sa["iteration"] == sb["iteration"])


def test_resume_is_bit_equal(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a new trainer that
    resumes it and 2 more: the same detector, heads, momentum and step."""
    straight = small_da(tmp_path / "a", "da", "SOLVER.MAX_ITER", "4")
    straight.train()
    first = small_da(tmp_path / "b", "da", "SOLVER.MAX_ITER", "2")
    first.train()
    resumed = small_da(tmp_path / "b", "da", "SOLVER.MAX_ITER", "4")
    resumed.resume_or_load(resume=True)
    assert resumed.state.step == 2
    resumed.train()
    assert states_equal(straight, resumed)
    with open(tmp_path / "b" / "metrics.json") as f:
        assert '"loss_DC_img"' in f.read()


def test_steps_per_dispatch_two_equals_one(tmp_path):
    """TPU.STEPS_PER_DISPATCH 2 (staged ahead on a thread) bit-equal to 1:
    targets are pulled in step order."""
    one = small_da(tmp_path / "a", "cda", "SOLVER.MAX_ITER", "3")
    two = small_da(tmp_path / "b", "cda", "SOLVER.MAX_ITER", "3", "TPU.STEPS_PER_DISPATCH", "2",
                   "TPU.CHUNK_STAGE_AHEAD", "1")
    recs = make_synthetic_records(3, IMAGE_HW, 8, 6, seed=11)
    for tr in (one, two):
        targets = iter([synthetic_batch([r], CANVAS, GT_CAP) for r in recs])
        tr._build_target_loader = lambda targets=targets: targets
        tr.train()
    assert states_equal(one, two)


def test_train_net_on_the_da_yaml(tmp_path):
    """`python -m simple_sfod_tpu_torch.tools.train_net` on the DA YAML, 2
    iterations on --synthetic data at 64x128: exit 0, finite DC losses in
    metrics.json, model_final.pth with the heads, eval_results.json, the
    launches line."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "simple_sfod_tpu_torch.tools.train_net", "--config-file", DA_YAML, "--synthetic",
           "--device", "cpu", *config_opts(OPTS), "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
           "SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "2", "OUTPUT_DIR", str(out), "DATALOADER.NUM_WORKERS", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [json.loads(x) for x in open(out / "metrics.json")]
    assert lines[-1]["iteration"] == 1
    assert all(np.isfinite(lines[-1][k]) for k in ("loss_DC_img", "loss_DC_ins", "loss_consistency", "total_loss"))
    assert (out / "model_final.pth").exists() and (out / "eval_results.json").exists()
    data = torch.load(out / "model_final.pth", weights_only=True)
    assert set(data["trainer"]["heads"]) == {"da_img", "da_ins"}
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("[launches] ")
    # on the CPU the NMS entries take their plain versions: no kernel launch
    assert json.loads(last[len("[launches] "):]) == {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}


def test_build_trainer_names_the_da_variants(tmp_path):
    from simple_sfod_tpu.engine.trainers import TRAINER_REGISTRY as JAX_REGISTRY
    from simple_sfod_tpu.engine.trainers import _import_all
    from simple_sfod_tpu_torch.engine.trainers import TRAINER_REGISTRY

    assert isinstance(build_trainer(da_cfg(get_cfg, tmp_path, "da"), device="cpu"), DATrainer)
    _import_all()
    assert set(JAX_REGISTRY) == set(TRAINER_REGISTRY)
