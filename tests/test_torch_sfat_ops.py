"""The port's pieces of the source-free adaptive-teacher step against the JAX
package's, on the CPU in float32, on the same numpy-seeded inputs and the
same JAX draws: the strong augmentation, the BPC loss and its candidates,
the pseudo-label pipeline, the EMA update, the domain classifiers, the
teacher's train-mode-BN pseudo forward and the bench configuration.

Tolerances and why:
  strong augmentation   erasing rectangles equal; pixels within 1 uint8
                        step: PIL's round-half-up after each op turns a
                        last-bit difference (XLA's and torch's exp, remainder
                        and sum orders) into one step where a value sits on
                        a .5 boundary
  bpc_loss, candidates  1e-5 relative: the same float32 operations, summed
                        in another order
  pseudo_pipeline       masks, reserve, classwise_acc and counts equal;
                        pseudo_mean_conf 1e-6 (a sum in another order)
  ema_update            1e-6 relative
  DC modules            1e-5 relative
  teacher forward       running statistics 1e-6 relative to each buffer's
                        largest entry (the first BatchNorm sees the same
                        input; deeper ones 1e-5, their inputs differ by the
                        convs' summation order); detections as in
                        test_torch_detector.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.data import transforms as JT
from simple_sfod_tpu_torch.data import transforms as PT

CANVAS = (64, 128)


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- JAX draws
def jax_image_strong_draws(key, hw):
    """The draws `simple_sfod_tpu/data/transforms.py:strong_augment` makes
    from `key` (split 12: bernoullis 0, 2, 3, 5-7; jitter 1; sigma 4;
    erasing geometry 8-10; fill 11), as numpy arrays in StrongDraws' layout
    (without the batch dim)."""
    keys = jax.random.split(key, 12)
    do = [jax.random.bernoulli(keys[0], 0.8), jax.random.bernoulli(keys[2], 0.2), jax.random.bernoulli(keys[3], 0.5)]
    do += [jax.random.bernoulli(keys[5 + i], p) for i, (p, _, _) in enumerate(JT._ERASE_PARAMS)]
    ck = jax.random.split(keys[1], 5)
    b, c, s, h = 0.4, 0.4, 0.4, 0.1  # color_jitter's defaults
    jitter = [
        jax.random.uniform(ck[0], (), minval=1 - b, maxval=1 + b),
        jax.random.uniform(ck[1], (), minval=1 - c, maxval=1 + c),
        jax.random.uniform(ck[2], (), minval=1 - s, maxval=1 + s),
        jax.random.uniform(ck[3], (), minval=-h, maxval=h),
    ]
    scale, log_ratio, offset = [], [], []
    for i, (_, sc, ratio) in enumerate(JT._ERASE_PARAMS):
        ek = jax.random.split(keys[8 + i], 5)
        scale.append(jax.random.uniform(ek[0], (10,), minval=sc[0], maxval=sc[1]))
        log_ratio.append(jax.random.uniform(ek[1], (10,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])))
        offset.append(jnp.stack([jax.random.uniform(ek[2], ()), jax.random.uniform(ek[3], ())]))
    return {
        "do": np.asarray(do, bool),
        "jitter": np.asarray(jitter, np.float32),
        "perm": np.asarray(jax.random.permutation(ck[4], 4), np.int64),
        "sigma": np.float32(jax.random.uniform(keys[4], (), minval=0.1, maxval=2.0)),
        "erase_scale": np.stack([np.asarray(a) for a in scale]),
        "erase_log_ratio": np.stack([np.asarray(a) for a in log_ratio]),
        "erase_offset": np.stack([np.asarray(a) for a in offset]),
        "fill": np.asarray(jax.random.normal(keys[11], (*hw, 3))),
    }


def jax_strong_draws(keys, hw) -> PT.StrongDraws:
    """StrongDraws of a batch from one JAX key per image (the SFAT step
    splits its strong-view key into one per image)."""
    per = [jax_image_strong_draws(k, hw) for k in keys]
    return PT.StrongDraws(*(T(np.stack([p[f] for p in per])) for f in PT.StrongDraws._fields))


# ---------------------------------------------------------------- inputs
def padded_image(seed, hw=CANVAS, true_hw=None):
    """uint8-valued float32 [H, W, 3], zero outside true_hw (the loader's
    padded canvas)."""
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (*hw, 3)).astype(np.float32)
    th, tw = true_hw or hw
    img[th:] = 0
    img[:, tw:] = 0
    return img, np.asarray([th, tw], np.int32)


TRUE_HW = [None, (50, 100)]  # the whole canvas, and a smaller content region


def within_one_step(got: torch.Tensor, want, chain: bool = False) -> None:
    """Pixels within 1 uint8 step, and a step only where a value sits on a
    rounding boundary (under 1% of them). In a chain of quantized ops
    (`chain`) a step taken by one op is scaled by a later op's factor (up to
    1.4) and can round to 2: at most 0.01% of the pixels may be 2 steps
    apart, none more."""
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    assert err.max() <= (2.0 if chain else 1.0), err.max()
    assert (err > 1.0).sum() <= 1e-4 * err.size, (err > 1.0).sum()
    assert (err > 1e-3).mean() < 0.01, (err > 1e-3).mean()


@pytest.mark.parametrize("true_hw", TRUE_HW)
@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue", "gray", "blur"])
def test_photometric_op_matches_jax(op, true_hw):
    img, thw = padded_image(3, true_hw=true_hw)
    ji, pi = jnp.asarray(img), T(img)
    jt, pt = jnp.asarray(thw), T(thw)
    f = np.float32(1.27)
    if op == "brightness":
        want, got = JT.adjust_brightness(ji, f), PT.adjust_brightness(pi, float(f))
    elif op == "contrast":
        want, got = JT.adjust_contrast(ji, f, true_hw=jt), PT.adjust_contrast(pi, float(f), pt)
    elif op == "saturation":
        want, got = JT.adjust_saturation(ji, f), PT.adjust_saturation(pi, float(f))
    elif op == "hue":
        d = np.float32(-0.073)
        want, got = JT.adjust_hue(ji, d), PT.adjust_hue(pi, float(d))
    elif op == "gray":
        want, got = JT.to_grayscale(ji), PT.to_grayscale(pi)
    else:
        s = np.float32(1.37)
        want, got = JT.gaussian_blur(ji, s, true_hw=jt), PT.gaussian_blur(pi, float(s), true_hw=pt)
    if op in ("brightness", "contrast", "saturation", "gray"):
        # quantized or plain products: the same float32 operations
        want, got = JT._pil_u8(want), PT._pil_u8(got)
    within_one_step(got, want)


@pytest.mark.parametrize("true_hw", TRUE_HW)
def test_color_jitter_matches_jax(true_hw):
    """The four ops in the JAX draw's order and factors, over keys and images
    (the jitted JAX chain fuses the blends, so its roundings can differ by a
    step from the ops one at a time, which the port matches)."""
    for seed in range(12):
        img, thw = padded_image(seed % 3, true_hw=true_hw)
        key = jax.random.PRNGKey(1000 + seed)
        ck = jax.random.split(key, 5)
        want = JT.color_jitter(key, jnp.asarray(img), true_hw=jnp.asarray(thw))
        factors = [
            jax.random.uniform(ck[0], (), minval=0.6, maxval=1.4), jax.random.uniform(ck[1], (), minval=0.6, maxval=1.4),
            jax.random.uniform(ck[2], (), minval=0.6, maxval=1.4), jax.random.uniform(ck[3], (), minval=-0.1, maxval=0.1),
        ]
        perm = np.asarray(jax.random.permutation(ck[4], 4)).tolist()
        got = PT.color_jitter(T(img), [float(f) for f in factors], perm, T(thw))
        within_one_step(got, want, chain=True)


@pytest.mark.parametrize("true_hw", TRUE_HW)
@pytest.mark.parametrize("call", [0, 1, 2])
def test_random_erasing_rectangle_equals_jax(call, true_hw):
    """The rectangle of each of the three calls, over 40 keys: found or not,
    and its corners, exactly (the JAX rectangle is where a sentinel fill
    lands)."""
    _, thw = padded_image(0, true_hw=true_hw)
    _, scale, ratio = JT._ERASE_PARAMS[call]
    sentinel = -7.0
    zero = jnp.zeros((*CANVAS, 3))
    fill = jnp.full((*CANVAS, 3), sentinel)
    found_any = 0
    for seed in range(40):
        key = jax.random.PRNGKey(100 * call + seed)
        out = np.asarray(JT.random_erasing(key, zero, scale=scale, ratio=ratio, noise=fill, true_hw=jnp.asarray(thw)))
        ek = jax.random.split(key, 5)
        sc = T(jax.random.uniform(ek[0], (10,), minval=scale[0], maxval=scale[1]))
        lr = T(jax.random.uniform(ek[1], (10,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])))
        off = T(np.asarray([jax.random.uniform(ek[2], ()), jax.random.uniform(ek[3], ())]))
        found, y0, x0, eh, ew = (int(v) for v in PT.erasing_rect(sc, lr, off, T(thw)))
        want = np.zeros(CANVAS, bool)
        if found:
            want[y0:y0 + eh, x0:x0 + ew] = True
            found_any += 1
        np.testing.assert_array_equal(out[..., 0] == sentinel, want)
        got = PT.random_erasing(torch.zeros((*CANVAS, 3)), sc, lr, off, torch.full((*CANVAS, 3), sentinel), T(thw))
        np.testing.assert_array_equal(got[..., 0].numpy() == sentinel, want)
    assert found_any > 20


def test_erasing_fill_truncates_and_wraps():
    key = jax.random.PRNGKey(5)
    want = np.asarray(JT._erasing_fill(key, (*CANVAS, 3)))
    got = PT._erasing_fill(T(jax.random.normal(key, (*CANVAS, 3)))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 256 and got.min() < 10 and got.max() > 245
    np.testing.assert_array_equal(PT._erasing_fill(T(np.float32([-1.7, -0.001, 3.9]))).numpy(), [79.0, 0.0, 226.0])


@pytest.mark.parametrize("true_hw", TRUE_HW)
def test_strong_augment_matches_jax(true_hw):
    """The whole pipeline (as the step runs it, under jit) on the JAX draws,
    over seeds that between them apply every op."""
    applied = np.zeros(6, int)
    for seed in range(16):
        img, thw = padded_image(50 + seed, true_hw=true_hw)
        key = jax.random.PRNGKey(seed)
        want = jax.jit(JT.strong_augment)(key, jnp.asarray(img), jnp.asarray(thw))
        draws = jax_strong_draws([key], CANVAS)
        applied += draws.do[0].numpy()
        got = PT.strong_augment(T(img), draws, 0, T(thw))
        within_one_step(got, want, chain=True)
    assert (applied > 0).all(), applied


def test_make_strong_draws_shapes_and_ranges():
    host = torch.Generator().manual_seed(0)
    dev = torch.Generator().manual_seed(1)
    d = PT.make_strong_draws(3, CANVAS, host, dev, torch.device("cpu"))
    assert d.do.shape == (3, 6) and d.do.dtype == torch.bool
    assert d.jitter.shape == (3, 4) and d.perm.shape == (3, 4) and d.sigma.shape == (3,)
    assert all(sorted(p.tolist()) == [0, 1, 2, 3] for p in d.perm)
    assert ((d.jitter[:, :3] >= 0.6) & (d.jitter[:, :3] <= 1.4)).all() and (d.jitter[:, 3].abs() <= 0.1).all()
    assert d.erase_scale.shape == (3, 3, 10) and d.erase_offset.shape == (3, 3, 2) and d.fill.shape == (3, *CANVAS, 3)
    for k, (_, sc, r) in enumerate(PT._ERASE_PARAMS):
        assert (d.erase_scale[:, k] >= sc[0]).all() and (d.erase_scale[:, k] <= sc[1]).all()
        assert (d.erase_log_ratio[:, k] >= np.log(r[0]) - 1e-6).all() and (d.erase_log_ratio[:, k] <= np.log(r[1]) + 1e-6).all()
    out = PT.strong_augment_batch(torch.full((3, *CANVAS, 3), 100.0), T(np.tile([[60, 120]], (3, 1)).astype(np.int32)), d)
    assert out.shape == (3, *CANVAS, 3) and torch.isfinite(out).all()


# ---------------------------------------------------------------- BPC
def bpc_case(seed, b=2, s=24, c=8, g=10):
    """Sampled ROI rows and pseudo GT: logits, per-class deltas, proposals
    around the GT boxes (so some candidates are true positives)."""
    rs = np.random.RandomState(seed)
    gt_xy = rs.uniform(0, 150, (b, g, 2))
    gt_boxes = np.concatenate([gt_xy, gt_xy + rs.uniform(20, 90, (b, g, 2))], -1).astype(np.float32)
    gt_classes = rs.randint(0, c, (b, g)).astype(np.int32)
    gt_valid = rs.rand(b, g) < 0.7
    pick = rs.randint(0, g, (b, s))
    props = np.take_along_axis(gt_boxes, pick[..., None], 1) + rs.normal(0, 4, (b, s, 4)).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 1)
    samp_cls = np.where(rs.rand(b, s) < 0.6, np.take_along_axis(gt_classes, pick, 1), c).astype(np.int32)
    valid = rs.rand(b, s) < 0.9
    scores = (rs.normal(0, 2, (b * s, c + 1))).astype(np.float32)
    deltas = (rs.normal(0, 0.3, (b * s, 4 * c))).astype(np.float32)
    sizes = np.asarray([[180, 240], [200, 230]], np.int32)[:b]
    return dict(gt=(gt_boxes, np.ones((b, g), np.float32), gt_classes, gt_valid), props=props.astype(np.float32),
                samp_cls=samp_cls, valid=valid, scores=scores, deltas=deltas, sizes=sizes)


def sampled(mod, case, to):
    b, s = case["samp_cls"].shape
    zeros = np.zeros((b, s, 4), np.float32)
    return mod.SampledProposals(to(case["props"]), to(case["samp_cls"]), to(zeros), to(case["samp_cls"] < 8), to(case["valid"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bpc_candidates_and_loss_match_jax(seed):
    from simple_sfod_tpu.losses.bpc import bpc_loss as jax_bpc_loss
    from simple_sfod_tpu.models import faster_rcnn as jfr
    from simple_sfod_tpu.structures.instances import Instances as JaxInstances
    from simple_sfod_tpu_torch.losses.bpc import bpc_loss
    from simple_sfod_tpu_torch.models import faster_rcnn as pfr
    from simple_sfod_tpu_torch.models.faster_rcnn import DetectorConfig
    from simple_sfod_tpu_torch.structures.instances import Instances

    case = bpc_case(seed)
    want = jfr.bpc_candidates(None, jnp.asarray(case["scores"]), jnp.asarray(case["deltas"]),
                              sampled(jfr, case, jnp.asarray), jnp.asarray(case["sizes"]))
    got = pfr.bpc_candidates(DetectorConfig(), T(case["scores"]), T(case["deltas"]), sampled(pfr, case, T), T(case["sizes"]))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    gt_j = JaxInstances(*(jnp.asarray(a) for a in case["gt"]))
    gt_p = Instances(*(T(a) for a in case["gt"]))
    want_loss = float(jax_bpc_loss(want, gt_j))
    got_loss = float(bpc_loss(got, gt_p))
    assert want_loss > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    # and on the JAX candidates themselves
    same = Instances(*(T(a) for a in (want.boxes, want.scores, want.classes, want.valid)))
    np.testing.assert_allclose(float(bpc_loss(same, gt_p)), want_loss, rtol=1e-5)


def test_legacy_iou_matches_jax():
    from simple_sfod_tpu.losses.bpc import _legacy_iou as jax_iou
    from simple_sfod_tpu_torch.losses.bpc import _legacy_iou

    rs = np.random.RandomState(4)
    a = rs.uniform(0, 50, (30, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = np.concatenate([a[:10], rs.uniform(0, 80, (20, 4)).astype(np.float32)])
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] - 3)  # some empty boxes
    np.testing.assert_allclose(_legacy_iou(T(a), T(b)).numpy(), np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- trainers' pieces
SMALL_OPTS = {
    "TPU": {"CANVAS": CANVAS, "MESH_DATA": 1, "DTYPE": "float32"},
    "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}},
    "ADAPTIVE_THRESHOLD": {"ENABLED": True, "WARM_UP": 2, "RESERVE": 3},
}


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX SFAT trainer and the port's on the same small configuration."""
    from simple_sfod_tpu.config import get_cfg as jax_get_cfg
    from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
    from simple_sfod_tpu_torch.config import get_cfg
    from simple_sfod_tpu_torch.config.defaults import SFAT_BENCH_CONFIG, config_opts
    from simple_sfod_tpu_torch.engine.trainers import build_trainer

    out = {}
    for side, get, build in (("jax", jax_get_cfg, jax_build_trainer), ("port", get_cfg, build_trainer)):
        cfg = get()
        cfg.merge_from_list(config_opts(SFAT_BENCH_CONFIG) + config_opts(SMALL_OPTS))
        cfg.OUTPUT_DIR = str(tmp_path_factory.mktemp(side))
        out[side] = build(cfg) if side == "jax" else build(cfg, device="cpu")
    return out


def random_dets(seed, b=2, k=50, c=8):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 100, (b, k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 60, (b, k, 2))], -1).astype(np.float32)
    scores = rs.uniform(0, 1, (b, k)).astype(np.float32)
    scores[:, :4] = np.float32(0.8)  # on the fixed threshold: > for the counts, >= for the pseudo-labels
    classes = rs.choice([0, 1, 2, 3, 5], (b, k), p=[0.3, 0.3, 0.2, 0.1, 0.1]).astype(np.int32)
    valid = rs.rand(b, k) < 0.8
    return boxes, scores, classes, valid


def test_pseudo_pipeline_matches_jax_across_warm_up_and_wrap(trainers):
    """Steps 0..6 of the pseudo-label pipeline with WARM_UP 2 and RESERVE 3:
    the fixed threshold at steps 0-1, the adaptive one after, the reserve
    row wrapping at step 3 and 6; masks, reserve, classwise_acc, cursor and
    the stats exactly."""
    from simple_sfod_tpu.engine.train_state import AdaptiveThresholdState as JaxThresh
    from simple_sfod_tpu.structures.instances import Instances as JaxInstances
    from simple_sfod_tpu_torch.structures.instances import Instances

    sys_jax, ptr = trainers["jax"], trainers["port"]
    pipeline = jax.jit(jax_closure_of(sys_jax._step_fn_raw, "pseudo_pipeline"))
    jthresh = JaxThresh.create(8, 3)
    differs = 0
    for step in range(7):
        boxes, scores, classes, valid = random_dets(step)
        jd = JaxInstances(*(jnp.asarray(a) for a in (boxes, scores, classes, valid)))
        want_gt, jthresh, want_stats = pipeline(jd, jthresh, jnp.int32(step))
        got_gt, got_stats = ptr.pseudo_pipeline(Instances(*(T(a) for a in (boxes, scores, classes, valid))), step)
        np.testing.assert_array_equal(got_gt.valid.numpy(), np.asarray(want_gt.valid), err_msg=f"step {step}")
        np.testing.assert_array_equal(got_gt.boxes.numpy(), np.asarray(want_gt.boxes))
        th = ptr.state.thresh
        np.testing.assert_array_equal(th.reserve.numpy(), np.asarray(jthresh.reserve), err_msg=f"step {step}")
        np.testing.assert_array_equal(th.classwise_acc.numpy(), np.asarray(jthresh.classwise_acc))
        assert th.cursor == int(jthresh.cursor) == step + 1
        assert int(got_stats["num_pseudo"]) == int(want_stats["num_pseudo"])
        # a mean: the same sum in another order
        np.testing.assert_allclose(float(got_stats["pseudo_mean_conf"]), float(want_stats["pseudo_mean_conf"]), rtol=1e-6)
        differs += int((got_gt.valid.numpy() != (valid & (scores >= np.float32(0.8)))).any())
    # the adaptive threshold changed the pseudo-labels after the warm-up
    assert differs > 0
    assert (th.classwise_acc.numpy()[[0, 2]] == 1.0).all()


def jax_closure_of(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_ema_update_matches_jax():
    from simple_sfod_tpu.engine.train_state import ema_update as jax_ema
    from simple_sfod_tpu_torch.engine.train_state import ema_update

    rs = np.random.RandomState(0)
    t = [rs.normal(0, 1, (5, 7)).astype(np.float32), rs.normal(0, 3, (11,)).astype(np.float32)]
    s = [a + rs.normal(0, 0.1, a.shape).astype(np.float32) for a in t]
    for keep in (0.9996, 0.99, 1.0):
        want = jax.jit(jax_ema, static_argnums=())(list(map(jnp.asarray, t)), list(map(jnp.asarray, s)), keep)
        got = [T(a) for a in t]
        ema_update(got, [T(a) for a in s], keep)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    same = [T(a) for a in t]
    ema_update(same, [T(a) for a in s], 1.0)
    assert all(torch.equal(a, T(b)) for a, b in zip(same, t))


@pytest.mark.parametrize("which", ["dc", "dc_ins"])
def test_domain_classifiers_match_jax(which):
    from simple_sfod_tpu.models.dann import DAInsHead as JaxIns
    from simple_sfod_tpu.models.dann import FCDiscriminatorImg as JaxImg
    from simple_sfod_tpu_torch.checkpoint.from_jax import dc_state_dict_from_jax
    from simple_sfod_tpu_torch.models.dann import DAInsHead, FCDiscriminatorImg, init_dc_weights

    rs = np.random.RandomState(1)
    if which == "dc":
        x = rs.normal(0, 1, (2, 4, 8, 512)).astype(np.float32)  # NHWC, vgg4 channels
        jmod, pmod = JaxImg(), FCDiscriminatorImg(512)
        params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))  # [B, h, w, 1]
        pmod.load_state_dict(dc_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), which))
        got = pmod(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    else:
        x = rs.normal(0, 1, (30, 64)).astype(np.float32)
        jmod, pmod = JaxIns(), DAInsHead(64)
        params = jmod.init(jax.random.key(0), jnp.asarray(x), train=False)["params"]
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), train=False))
        pmod.load_state_dict(dc_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), which))
        got = pmod(T(x)).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the seeded init: the JAX initialisers' scales, the same on every call
    a = init_dc_weights(FCDiscriminatorImg(512) if which == "dc" else DAInsHead(64), 3).state_dict()
    b = init_dc_weights(FCDiscriminatorImg(512) if which == "dc" else DAInsHead(64), 3).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
        jk = np.asarray(params[k.split(".")[0]]["kernel" if k.endswith("weight") else "bias"])
        if k.endswith("weight"):
            assert abs(float(a[k].std()) / float(jk.std()) - 1) < 0.15, k
        else:
            assert not a[k].any() and not jk.any()


@pytest.fixture(scope="module")
def detectors():
    from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
    from simple_sfod_tpu.config import get_cfg as jax_get_cfg
    from simple_sfod_tpu.models.detector import Detector as JaxDetector
    from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
    from test_torch_detector import lowered

    jcfg = jax_lower(lowered(jax_get_cfg))
    pcfg = detector_config_from_cfg(lowered(get_cfg))
    jdet = JaxDetector(jcfg)
    variables = jax.tree_util.tree_map(np.array, jdet.init(jax.random.key(0), (128, 256)))
    variables["params"]["predictor"]["cls_score"]["bias"][1] += 4.0
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 256, 3)).astype(np.uint8)
    sizes = np.asarray([[120, 250], [128, 200]], np.int32)
    return dict(jdet=jdet, variables=variables, pcfg=pcfg, images=images, sizes=sizes,
                state=state_dict_from_jax(variables, pcfg))


def test_teacher_pseudo_forward_matches_jax(detectors):
    """The teacher's train-mode-BN forward (running statistics moved, then
    detections), and the batch-statistics inference that moves nothing
    (infer(train_mode_bn=True)), against the JAX package's."""
    from simple_sfod_tpu_torch.models.detector import Detector
    from test_torch_detector import _assert_detections
    from test_torch_train_model import bn_buffers, bn_tolerance
    from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax

    d = detectors
    jdet, variables, pcfg = d["jdet"], d["variables"], d["pcfg"]
    images, sizes = jnp.asarray(d["images"]), jnp.asarray(d["sizes"])

    def teacher(v, im, sz):
        feat, mut = jdet._features(v, im, True, mutable=True)
        return jdet.infer_from_feature(v, feat, sz, (128, 256)), mut["batch_stats"]

    want, stats = jax.jit(teacher)(variables, images, sizes)
    det = Detector(pcfg, device="cpu").load_state_dict(d["state"])
    got = det.pseudo_labels(torch.from_numpy(d["images"]), torch.from_numpy(d["sizes"]))
    assert not got.boxes.requires_grad and not torch.is_inference(got.boxes)
    _assert_detections(got, want, 1e-3, 1e-5, 1e-5)
    want_stats = bn_buffers(state_dict_from_jax({"params": variables["params"], "batch_stats": stats}, pcfg))
    moved = 0
    for k, v in bn_buffers(det.model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=0,
                                   atol=bn_tolerance(k) * np.abs(want_stats[k].numpy()).max(), err_msg=k)
        moved += int(not torch.equal(v, d["state"][k]))
    assert moved == 26  # every BatchNorm's mean and variance

    want2 = jax.jit(lambda v, im, sz: jdet.infer(v, im, sz, train_mode_bn=True))(variables, images, sizes)
    before = {k: v.clone() for k, v in bn_buffers(det.model.state_dict()).items()}
    got2 = det.infer(d["images"], d["sizes"], train_mode_bn=True)
    _assert_detections(got2, want2, 1e-3, 1e-5, 1e-5)
    assert all(torch.equal(v, before[k]) for k, v in bn_buffers(det.model.state_dict()).items())
    # bn_update moves them as the pseudo forward does
    want3 = jax.jit(jdet.bn_update)(variables, images)
    det2 = Detector(pcfg, device="cpu").load_state_dict(d["state"])
    det2.bn_update(d["images"])
    want3 = bn_buffers(state_dict_from_jax({"params": variables["params"], "batch_stats": want3}, pcfg))
    for k, v in bn_buffers(det2.model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), want3[k].numpy(), rtol=0, atol=bn_tolerance(k) * np.abs(want3[k].numpy()).max())


def test_bfloat16_parameters_with_float32_statistics():
    """The fixed bfloat16 teacher's BatchNorm: bfloat16 weight and bias,
    float32 running statistics that stay float32 through train-mode updates
    and eval, under bfloat16 autocast as the detector runs it."""
    from simple_sfod_tpu_torch.models.backbones.vgg import BatchNorm2d

    bn = BatchNorm2d(6)
    ref = BatchNorm2d(6)
    with torch.no_grad():
        for m in (bn, ref):
            m.weight.copy_(torch.linspace(0.5, 1.5, 6))
            m.bias.copy_(torch.linspace(-1, 1, 6))
    bn.weight.data, bn.bias.data = bn.weight.data.bfloat16(), bn.bias.data.bfloat16()
    x = torch.randn(2, 6, 5, 7) * 3 + 1
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = bn(x.bfloat16(), train=True)
        y_eval = bn(x.bfloat16(), train=False)
    ref(x, train=True)
    assert y.dtype == torch.bfloat16 and y_eval.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    # the statistics move from the same (bfloat16) input as the float32 layer's, to bfloat16's precision
    np.testing.assert_allclose(bn.running_mean.numpy(), ref.running_mean.numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(bn.running_var.numpy(), ref.running_var.numpy(), rtol=2e-2)
    np.testing.assert_allclose(y.detach().float().numpy(), ref(x, train=True, update_stats=False).detach().numpy(), atol=0.1)


# ---------------------------------------------------------------- config, data, weights
def test_sfat_bench_cfg_equals_jax_key_for_key():
    from simple_sfod_tpu.utils.bench import sfat_bench_cfg
    from simple_sfod_tpu_torch.config import get_sfat_bench_cfg

    def plain(node):
        return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}

    assert plain(get_sfat_bench_cfg(output_dir="./output/x")) == plain(sfat_bench_cfg(output_dir="./output/x"))
    ours = get_sfat_bench_cfg()
    assert ours.WEAK_STRONG_AUGMENT and ours.ADAPTIVE_THRESHOLD.ENABLED and not ours.DOMAIN_CLASSIFIER.ENABLED
    assert ours.TPU.DTYPE == "bfloat16" and tuple(ours.TPU.CANVAS) == (608, 1216) and ours.SOLVER.IMS_PER_BATCH_TARGET == 1
    with pytest.raises(AttributeError, match="frozen"):
        ours.SEED = 1


def test_synthetic_bench_batch_equals_jax():
    from simple_sfod_tpu.utils.bench import sfat_bench_cfg, synthetic_bench_batch as jax_batch
    from simple_sfod_tpu_torch.config import get_sfat_bench_cfg
    from simple_sfod_tpu_torch.utils.bench import synthetic_bench_batch

    for n in (None, 2):
        ours = synthetic_bench_batch(get_sfat_bench_cfg(output_dir="./output/x"), n)
        theirs = jax_batch(sfat_bench_cfg(output_dir="./output/x"), n)
        assert set(ours) == set(theirs) == {"images", "sizes"}
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
            assert ours[k].dtype == theirs[k].dtype


def test_teacher_student_from_jax_matches_export_ensemble(tmp_path):
    """The JAX adaptation state of the main configuration (bfloat16 fixed
    teacher, both domain classifiers) from the JAX trainer's _init_state:
    student and teacher key for key and value for value against the JAX
    package's export_ensemble; the domain classifiers and the threshold
    statistics against the JAX tree."""
    from simple_sfod_tpu.checkpoint.torch_export import export_ensemble
    from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
    from simple_sfod_tpu.config import get_cfg as jax_get_cfg
    from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
    from simple_sfod_tpu_torch.checkpoint.from_jax import teacher_student_from_jax
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
    from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG, config_opts
    from simple_sfod_tpu_torch.engine.trainers import build_trainer

    opts = config_opts(MAIN_CONFIG) + config_opts({"TPU": {"CANVAS": CANVAS, "MESH_DATA": 1},
                                                   "MODEL": {"ROI_BOX_HEAD": {"FC_DIM": 64}}})
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(opts)
    jcfg.OUTPUT_DIR = str(tmp_path)
    jtr = jax_build_trainer(jcfg)
    state = jax.tree_util.tree_map(np.asarray, jtr.state)
    assert state.teacher_params["predictor"]["cls_score"]["kernel"].dtype == jnp.bfloat16
    pcfg_node = get_cfg()
    pcfg_node.merge_from_list(opts)
    pcfg = detector_config_from_cfg(pcfg_node)
    w = teacher_student_from_jax(state, pcfg)
    want = export_ensemble(state.params["det"], state.batch_stats, state.teacher_params, state.teacher_stats, jax_lower(jcfg))
    got = {f"modelStudent.{k}": v for k, v in w.student.items()} | {f"modelTeacher.{k}": v for k, v in w.teacher.items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    assert set(w.dc) == set(state.params) - {"det"} == {"dc", "dc_ins"}
    np.testing.assert_array_equal(w.dc["dc"]["conv1.weight"].numpy(),
                                  np.transpose(state.params["dc"]["conv1"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(w.dc["dc_ins"]["fc2.weight"].numpy(), state.params["dc_ins"]["fc2"]["kernel"].T)
    np.testing.assert_array_equal(w.thresh["reserve"].numpy(), state.thresh.reserve)
    np.testing.assert_array_equal(w.thresh["classwise_acc"].numpy(), state.thresh.classwise_acc)
    assert w.thresh["cursor"] == int(state.thresh.cursor) == 0
    # the port's trainer takes it whole, and casts the fixed teacher back to bfloat16 exactly
    ptr = build_trainer(pcfg_node, device="cpu", weights=w)
    t = ptr.state.teacher.state_dict()
    key = "roi_heads.box_predictor.cls_score.weight"
    assert t[key].dtype == torch.bfloat16
    np.testing.assert_array_equal(t[key].float().numpy(), w.teacher[key].numpy())
    assert set(ptr.state.dc) == {"dc", "dc_ins"}
    names = set(ptr.state.optimizer.names)
    assert {"dc.conv1.weight", "dc_ins.fc3.bias"} <= names and len(names) == len(list(ptr.state.model.parameters())) + 14
