"""The port's training functions of the detector against the JAX package's
on the CPU, in float32, VGG16-BN at a 128x256 canvas with FC_DIM 64, on
weights initialised by JAX and carried across by checkpoint/from_jax.py.
Every sampler gets the JAX package's own priorities (`jax_loss_draws`).

Tolerances and why:
  train-mode propose       valid equal, boxes 1e-4 px: same RPN outputs
  rpn_losses, roi_losses   1e-5 relative: same inputs, sums in another order
  label_and_sample         indices, classes, masks equal; targets 1e-5
  ROIAlign gradient        1e-5 of its largest entry
  BN running statistics    1e-6 relative to each buffer's largest entry
                           where the BatchNorm sees the same input (one
                           layer against flax's, and the backbone's first);
                           1e-5 deeper, whose inputs already differ by the
                           convs' summation order
  supervised_losses        losses 1e-4 relative, counts equal: the feature
                           differs by the 13 convs' summation order
  train-mode BN gradient   1e-5 of its largest entry against float64
  RPN head gradients       1e-5 of each tensor's largest entry, on the
                           same feature
  supervised gradients     1e-4 for the layers after the RPN's 3x3 conv and
                           the box head; 25% for that conv and the backbone:
                           their inputs differ by rounding, and on a 4x8
                           feature map one ReLU that flips sign moves a
                           channel's gradient by percents; with flax's
                           inexact BatchNorm gradient (below) on top

A known deviation of the reference, pinned here and not copied: flax's
BatchNorm computes the batch variance as E[x^2] - E[x]^2
(`use_fast_variance=True`), and in float32 the gradient through that
formula loses digits. On a conv-BN-ReLU stack the JAX package's weight
gradients end up percents away from a float64 run of the same stack, while
the port's (torch's BatchNorm, two-pass variance) stay within 1e-5
(`test_bn_gradient_against_float64`). So the full detector's backbone
gradients, and the weights after training steps, differ between the two
packages by more than rounding (test_torch_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.models import faster_rcnn as jfr
from simple_sfod_tpu.models.detector import DetectionBatch as JaxBatch
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.ops.roi_align import roi_align as jax_roi_align
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.models import faster_rcnn as pfr
from simple_sfod_tpu_torch.models.detector import DetectionBatch, Detector
from simple_sfod_tpu_torch.ops.roi_align import roi_align
from simple_sfod_tpu_torch.structures.instances import Instances

CANVAS = (128, 256)
GT_CAP = 8
OPTS = [
    "MODEL.BACKBONE.NAME", "build_vgg_backbone",
    "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)",
    "MODEL.RPN.IN_FEATURES", "('vgg4',)",
    "MODEL.ROI_HEADS.NUM_CLASSES", "8",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",
    "TPU.CANVAS", str(CANVAS),
]


def T(a):
    return torch.from_numpy(np.array(a))


def jax_loss_draws(rng, batch_size, num_anchors, pool):
    """The samplers' priorities that the JAX package's losses_from_feature
    draws from `rng`: split(rng, 3) -> (rpn, roi, dropout), then one key
    per image, then uniform((n,)). -> (rpn [B, N], roi [B, pool]) numpy."""
    rng_rpn, rng_roi, _ = jax.random.split(rng, 3)
    rpn = [jax.random.uniform(k, (num_anchors,)) for k in jax.random.split(rng_rpn, batch_size)]
    roi = [jax.random.uniform(k, (pool,)) for k in jax.random.split(rng_roi, batch_size)]
    return np.stack(rpn), np.stack(roi)


def lowered(get):
    cfg = get()
    cfg.merge_from_list(OPTS)
    return cfg


def gt_case(seed, b=2):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, [CANVAS[1] - 70, CANVAS[0] - 50], (b, GT_CAP, 2))
    wh = rs.uniform([20, 15], [120, 70], (b, GT_CAP, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rs.randint(0, 8, (b, GT_CAP)).astype(np.int32)
    valid = np.zeros((b, GT_CAP), bool)
    valid[0, :3] = True
    valid[1, :5] = True
    return boxes, classes, valid


def both_gt(boxes, classes, valid):
    scores = np.ones(classes.shape, np.float32)
    return (
        JaxInstances(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid)),
        Instances(T(boxes), T(scores), T(classes), T(valid)),
    )


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_lower(lowered(jax_get_cfg))
    pcfg = detector_config_from_cfg(lowered(get_cfg))
    jdet = JaxDetector(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.key(0), CANVAS))
    pdet = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2,) + CANVAS + (3,)).astype(np.uint8)
    sizes = np.asarray([[120, 250], [128, 200]], np.int32)
    feat = np.array(jdet._features(variables, jnp.asarray(images), False))
    logits, deltas = jdet.module.apply(variables, jnp.asarray(feat), method=jfr.FasterRCNN.rpn)
    anchors = jfr.anchors_for(jcfg, CANVAS)
    return dict(
        jcfg=jcfg, pcfg=pcfg, jdet=jdet, variables=variables, pdet=pdet, images=images, sizes=sizes,
        feat=feat, logits=np.array(logits), deltas=np.array(deltas), anchors=np.asarray(anchors),
    )


def jax_rpn(pair):
    return jfr.RPNOutput(jnp.asarray(pair["logits"]), jnp.asarray(pair["deltas"]))


def port_rpn(pair):
    return pfr.RPNOutput(T(pair["logits"]), T(pair["deltas"]))


def test_train_mode_propose(pair):
    want = jfr.propose(pair["jcfg"], jnp.asarray(pair["anchors"]), jax_rpn(pair), jnp.asarray(pair["sizes"]), training=True)
    got = pfr.propose(pair["pcfg"], T(pair["anchors"]), port_rpn(pair), T(pair["sizes"]), training=True)
    pre_k, post_k = pfr.proposal_counts(pair["pcfg"], pair["anchors"].shape[0], True)
    assert got.boxes.shape == (2, post_k, 4) and pre_k == post_k == 480
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 50
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_losses_on_jax_priorities(pair, seed):
    jgt, pgt = both_gt(*gt_case(seed))
    rng = jax.random.key(seed)
    n = pair["anchors"].shape[0]
    prio = np.stack([jax.random.uniform(k, (n,)) for k in jax.random.split(rng, 2)])
    want = jfr.rpn_losses(pair["jcfg"], jnp.asarray(pair["anchors"]), jax_rpn(pair), jgt, rng)
    got = pfr.rpn_losses(pair["pcfg"], T(pair["anchors"]), port_rpn(pair), pgt, T(prio))
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["loss_rpn_loc"]) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_label_and_sample_proposals_on_jax_priorities(pair, seed):
    jcfg, pcfg = pair["jcfg"], pair["pcfg"]
    props = jfr.propose(jcfg, jnp.asarray(pair["anchors"]), jax_rpn(pair), jnp.asarray(pair["sizes"]), training=True)
    jgt, pgt = both_gt(*gt_case(seed + 10))
    rng = jax.random.key(seed)
    pool = pfr.roi_pool_size(pcfg, pair["anchors"].shape[0], GT_CAP)
    prio = np.stack([jax.random.uniform(k, (pool,)) for k in jax.random.split(rng, 2)])
    want = jfr.label_and_sample_proposals(jcfg, props, jgt, rng)
    pprops = Instances(*(T(np.asarray(x)) for x in (props.boxes, props.scores, props.classes, props.valid)))
    got = pfr.label_and_sample_proposals(pcfg, pprops, pgt, T(prio))
    for field in ("boxes", "gt_classes", "is_fg", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets), rtol=1e-5, atol=1e-5)
    # real sampling: the pool holds more candidates than the batch takes
    assert 0 < int(got.is_fg.sum()) < int(got.valid.sum()) == 2 * pcfg.roi_batch_size_per_image



def test_roi_losses(pair):
    jcfg, pcfg = pair["jcfg"], pair["pcfg"]
    props = jfr.propose(jcfg, jnp.asarray(pair["anchors"]), jax_rpn(pair), jnp.asarray(pair["sizes"]), training=True)
    jgt, pgt = both_gt(*gt_case(3))
    sampled = jfr.label_and_sample_proposals(jcfg, props, jgt, jax.random.key(3))
    rs = np.random.RandomState(3)
    r = sampled.boxes.shape[0] * sampled.boxes.shape[1]
    scores = rs.normal(0, 2, (r, 9)).astype(np.float32)
    deltas = rs.normal(0, 1, (r, 32)).astype(np.float32)
    want = jfr.roi_losses(jcfg, jnp.asarray(scores), jnp.asarray(deltas), sampled)
    psampled = pfr.SampledProposals(*(T(np.asarray(x)) for x in sampled))
    got = pfr.roi_losses(pcfg, T(scores), T(deltas), psampled)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["loss_box_reg"]) > 0


@pytest.mark.parametrize("hw", [(5, 9), (9, 5)])
def test_roi_align_gradient_against_jax_grad(hw):
    """Autograd through both contraction orders against jax.grad of the
    JAX package's roi_align, with respect to the feature map."""
    rs = np.random.RandomState(hw[0])
    feat = rs.normal(0, 1, hw + (6,)).astype(np.float32)
    xy = rs.uniform(-40, 200, (10, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 150, (10, 2))], 1).astype(np.float32)
    cot = rs.normal(0, 1, (10, 7, 7, 6)).astype(np.float32)

    def f(x):
        return jnp.sum(jax_roi_align(x, jnp.asarray(rois), 1 / 32, 7, 2, True) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(feat)))
    x = T(feat).permute(2, 0, 1).requires_grad_()
    out = roi_align(x, T(rois), 1 / 32)
    (out * T(cot).permute(0, 3, 1, 2)).sum().backward()
    got = x.grad.permute(1, 2, 0).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def bn_buffers(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def bn_tolerance(key):
    return 1e-6 if key.startswith("backbone.vgg0.1.") else 1e-5


@pytest.mark.parametrize("update_stats", [True, False])
def test_batchnorm_layer_matches_flax(update_stats):
    """One BatchNorm2d against flax's nn.BatchNorm(momentum=0.9), the JAX
    VGG's, on the same input with a large mean: output and running
    statistics (biased variance), or untouched statistics. Channel means
    of up to one standard deviation, like a conv's output: flax computes
    the variance as E[x^2] - E[x]^2, which loses digits as the mean grows
    against the deviation (the port's var_mean does not)."""
    import flax.linen as fnn

    from simple_sfod_tpu_torch.models.backbones.vgg import BatchNorm2d

    rs = np.random.RandomState(1)
    c = 16
    std = rs.uniform(0.5, 30, c)
    x = ((rs.normal(0, 1, (2, 6, 7, c)) + rs.uniform(-1, 1, c)) * std).astype(np.float32)
    scale, bias = rs.uniform(0.5, 2, c).astype(np.float32), rs.normal(0, 1, c).astype(np.float32)
    mean0, var0 = rs.normal(0, 1, c).astype(np.float32), rs.uniform(0.5, 2, c).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, mutated = flax_bn.apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"],
    )
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
        got = bn(T(x).permute(0, 3, 1, 2), train=True, update_stats=update_stats)
    want = np.asarray(want)
    # the output through the two variance formulas: 1e-5 of its largest entry
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    if update_stats:
        expect = mutated["batch_stats"]["mean"], mutated["batch_stats"]["var"]
    else:
        expect = mean0, var0
    for g, w in zip((bn.running_mean, bn.running_var), expect):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_train_mode_bn_running_stats(pair):
    """One train-mode pass of the backbone writes what flax writes to
    batch_stats; update_bn=False leaves the statistics alone."""
    jdet, variables, pcfg = pair["jdet"], pair["variables"], pair["pcfg"]
    jfeat, mutated = jdet._features(variables, jnp.asarray(pair["images"]), True, mutable=True)
    want = bn_buffers(state_dict_from_jax({"params": variables["params"], "batch_stats": mutated["batch_stats"]}, pcfg))
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    before = {k: v.clone() for k, v in bn_buffers(det.model.state_dict()).items()}
    with torch.no_grad():
        frozen = det.model.features(T(pair["images"]), train=True, update_bn=False)
        assert all(torch.equal(v, before[k]) for k, v in bn_buffers(det.model.state_dict()).items())
        feat = det.model.features(T(pair["images"]), train=True, update_bn=True)
    got = bn_buffers(det.model.state_dict())
    assert set(got) == set(want) and len(got) == 26
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=bn_tolerance(k) * np.abs(w.numpy()).max(), err_msg=k)
        assert not torch.equal(got[k], before[k])
    jfeat = np.asarray(jfeat)
    for f in (frozen, feat):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), jfeat, rtol=0, atol=1e-4 * np.abs(jfeat).max())


@pytest.mark.parametrize("update_bn", [True, False])
def test_supervised_losses_on_jax_draws(pair, update_bn):
    jdet, variables, jcfg, pcfg = pair["jdet"], pair["variables"], pair["jcfg"], pair["pcfg"]
    boxes, classes, valid = gt_case(5)
    jgt, pgt = both_gt(boxes, classes, valid)
    rng = jax.random.key(5)
    total, metrics, stats = jax.jit(
        lambda v, im, sz, g, r: jdet.supervised_losses(v, JaxBatch(im, sz, g), r, update_bn=update_bn)
    )(variables, jnp.asarray(pair["images"], jnp.float32), jnp.asarray(pair["sizes"]), jgt, rng)
    n = pair["anchors"].shape[0]
    rpn, roi = jax_loss_draws(rng, 2, n, pfr.roi_pool_size(pcfg, n, GT_CAP))
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    batch = DetectionBatch(T(pair["images"]).float(), T(pair["sizes"]), pgt)
    got_total, got = det.supervised_losses(batch, T(rpn), T(roi), update_bn=update_bn)
    assert got_total.requires_grad
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(total), rtol=1e-4)
    for k in ("num_fg", "num_sampled"):
        assert int(got[k]) == int(metrics[k]), k
    want = bn_buffers(state_dict_from_jax({"params": variables["params"], "batch_stats": stats}, pcfg))
    for k, v in bn_buffers(det.model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=bn_tolerance(k) * np.abs(want[k].numpy()).max(), err_msg=k)
    # with_bpc logs the BPC loss, outside the total and without a gradient
    _, jm_bpc, _ = jax.jit(
        lambda v, im, sz, g, r: jdet.supervised_losses(v, JaxBatch(im, sz, g), r, update_bn=False, with_bpc=True)
    )(variables, jnp.asarray(pair["images"], jnp.float32), jnp.asarray(pair["sizes"]), jgt, rng)
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    bpc_total, bpc = det.supervised_losses(batch, T(rpn), T(roi), update_bn=False, with_bpc=True)
    np.testing.assert_allclose(bpc_total.item(), float(total), rtol=1e-4)
    assert not bpc["loss_bpc"].requires_grad and float(jm_bpc["loss_bpc"]) > 0
    np.testing.assert_allclose(bpc["loss_bpc"].item(), float(jm_bpc["loss_bpc"]), rtol=1e-4)


def test_rpn_head_gradients_on_the_same_feature(pair):
    """The RPN losses' gradients with respect to the RPN head, on the JAX
    feature, with the JAX priorities."""
    jdet, variables, jcfg, pcfg = pair["jdet"], pair["variables"], pair["jcfg"], pair["pcfg"]
    jgt, pgt = both_gt(*gt_case(5))
    rng = jax.random.key(7)
    anchors = jnp.asarray(pair["anchors"])

    def loss(params):
        logits, deltas = jdet.module.apply({"params": params}, jnp.asarray(pair["feat"]), method=jfr.FasterRCNN.rpn)
        out = jfr.rpn_losses(jcfg, anchors, jfr.RPNOutput(logits, deltas), jgt, rng)
        return out["loss_rpn_cls"] + out["loss_rpn_loc"]

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))
    want = state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]}, pcfg)
    n = pair["anchors"].shape[0]
    prio = np.stack([jax.random.uniform(k, (n,)) for k in jax.random.split(rng, 2)])
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    out = pfr.rpn_losses(pcfg, T(pair["anchors"]), det.model.rpn(T(pair["feat"]).permute(0, 3, 1, 2)), pgt, T(prio))
    (out["loss_rpn_cls"] + out["loss_rpn_loc"]).backward()
    head = [(n_, p) for n_, p in det.model.named_parameters() if n_.startswith("proposal_generator.")]
    assert len(head) == 6
    for name, p in head:
        w = want[name].numpy()
        assert np.abs(w).max() > 0 or name.endswith("anchor_deltas.bias")
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=name)


def test_supervised_gradients_on_jax_draws(pair):
    """Gradients of the total loss at identical weights and draws. The
    layers after the RPN's 3x3 conv and the box head agree to rounding;
    that conv and the backbone cannot (see the module docstring), and the
    bound there still catches a gradient that is missing or of another
    loss."""
    from simple_sfod_tpu.models.detector import DetectionBatch as JaxBatch

    jdet, variables, pcfg = pair["jdet"], pair["variables"], pair["pcfg"]
    jgt, pgt = both_gt(*gt_case(5))
    rng = jax.random.key(5)

    def loss(params):
        batch = JaxBatch(jnp.asarray(pair["images"], jnp.float32), jnp.asarray(pair["sizes"]), jgt)
        return jdet.supervised_losses({"params": params, "batch_stats": variables["batch_stats"]}, batch, rng)[0]

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(variables["params"]))
    want = state_dict_from_jax({"params": grads, "batch_stats": variables["batch_stats"]}, pcfg)
    n = pair["anchors"].shape[0]
    rpn, roi = jax_loss_draws(rng, 2, n, pfr.roi_pool_size(pcfg, n, GT_CAP))
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    total, _ = det.supervised_losses(DetectionBatch(T(pair["images"]).float(), T(pair["sizes"]), pgt), T(rpn), T(roi))
    total.backward()
    for name, p in det.model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        feeds_bn = name.startswith("backbone.") and name.endswith(".bias") and int(name.split(".")[-2]) % 3 == 0
        if feeds_bn:  # a conv bias feeding a BatchNorm: its exact gradient is 0
            assert np.abs(p.grad.numpy()).max() <= 1e-5 * np.abs(want[name[:-4] + "weight"].numpy()).max()
        elif name.startswith(("backbone.", "proposal_generator.rpn_head.conv.")):
            assert err <= 0.25, (name, err)
        else:
            assert err <= 1e-4, (name, err)


def test_bn_gradient_against_float64():
    """Four conv-BN-ReLU layers with a 2x2 max-pool after the second, in
    float32: the port's weight gradients against the same stack in float64
    within 1e-5; the JAX package's flax BatchNorm (fast variance) misses by
    more than 1e-3 on at least one layer (the pinned deviation above)."""
    import flax.linen as fnn

    from simple_sfod_tpu.models.backbones.vgg import max_pool_2x2
    from simple_sfod_tpu_torch.models.backbones.vgg import BatchNorm2d

    rs = np.random.RandomState(0)
    c, h, w, layers = 64, 16, 32, 4
    x = np.maximum(rs.normal(0, 1, (2, h, w, c)), 0).astype(np.float32)
    kernels = [(rs.normal(0, 1, (3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32) for _ in range(layers)]
    cot = rs.normal(0, 1, (2, h // 2, w // 2, c)).astype(np.float32)

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, y):
            for i in range(layers):
                y = fnn.Conv(c, (3, 3), padding=1, name=f"conv{i}")(y)
                y = fnn.relu(fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, name=f"bn{i}")(y))
                if i == 1:
                    y = max_pool_2x2(y)
            return y

    stack = Stack()
    stats = stack.init(jax.random.key(0), jnp.asarray(x))["batch_stats"]
    params = {f"conv{i}": {"kernel": jnp.asarray(k), "bias": jnp.zeros(c)} for i, k in enumerate(kernels)}
    params.update({f"bn{i}": {"scale": jnp.ones(c), "bias": jnp.zeros(c)} for i in range(layers)})

    def loss(p):
        y, _ = stack.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(y * cot)

    jax_grads = jax.jit(jax.grad(loss))(params)

    def port_grads(dtype):
        convs = [torch.nn.Conv2d(c, c, 3, padding=1).to(dtype) for _ in range(layers)]
        bns = [BatchNorm2d(c).to(dtype) for _ in range(layers)]
        with torch.no_grad():
            for conv, k in zip(convs, kernels):
                conv.weight.copy_(T(np.transpose(k, (3, 2, 0, 1))))
                conv.bias.zero_()
        y = T(x).permute(0, 3, 1, 2).to(dtype)
        for i in range(layers):
            y = torch.relu(bns[i](convs[i](y), train=True))
            if i == 1:
                y = torch.nn.functional.max_pool2d(y, 2, 2)
        (y * T(cot).permute(0, 3, 1, 2).to(dtype)).sum().backward()
        return [np.transpose(conv.weight.grad.double().numpy(), (2, 3, 1, 0)) for conv in convs]

    truth, ours = port_grads(torch.float64), port_grads(torch.float32)

    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())

    port_err = [err(g, t) for g, t in zip(ours, truth)]
    jax_err = [err(jax_grads[f"conv{i}"]["kernel"], t) for i, t in enumerate(truth)]
    assert max(port_err) <= 1e-5, port_err
    assert max(jax_err) > 1e-3, jax_err
