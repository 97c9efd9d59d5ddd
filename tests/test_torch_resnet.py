"""The port's ResNet-50/101 C4 backbone (simple_sfod_tpu_torch/models/
backbones/resnet.py) against the JAX package's, on the CPU in float32.

  - The backbone's res4 feature at depth 50 on a 128x256 canvas, from the
    same weights (checkpoint/from_jax.py) with random statistics, in eval
    and train mode, for NORM BN and FrozenBN, and the running statistics
    that a train-mode forward leaves behind. Eval mode within 1e-5 of the
    feature's largest entry; train mode within 1e-3 (normalising by the
    batch's statistics through 16 blocks amplifies the convolutions'
    summation-order differences: 1.9e-4 measured); the statistics within
    1e-4 of each buffer's largest entry (1e-6 where the layer sees the
    image itself, the stem).
  - `state_dict_from_jax` key for key and value for value equal to the JAX
    package's `export_torch_checkpoint`, for resnet50 and resnet101 x BN
    and FrozenBN (the trees' shapes from `jax.eval_shape` of the JAX init,
    filled with seeded values: no forward at depth 101), and the port's
    FasterRCNN takes the result with strict=True.
  - `detector_config_from_cfg` of every R101 YAML equal field for field to
    the JAX package's lowering, and each YAML building its trainer.
  - EMA over as many tensors as the JAX package blends (FrozenBN's affine
    and statistics included).
  - The known departures from Detectron2, pinned: the JAX `reset_bn_stats`
    zeroes FrozenBN statistics (a fault of the reference, repaired in the
    port: test_torch_adabn.py); stem and res2 keep live, moving BatchNorm
    under FREEZE_AT 2 in both packages (Detectron2 converts them to
    FrozenBN; followed: test_torch_trainer.py).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint.torch_export import export_torch_checkpoint
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.trainers.base import reset_bn_tree
from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models.backbones.resnet import BLOCK_COUNTS, FrozenBatchNorm2d, ResNetBackbone
from simple_sfod_tpu_torch.models.backbones.vgg import BatchNorm2d
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R101_YAMLS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs", "r*101_c4_*.yaml")))
CANVAS = (128, 256)
SMALL = ["MODEL.ROI_BOX_HEAD.FC_DIM", "64", "TPU.DTYPE", "float32"]


def cfg_pair(*opts):
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_list(SMALL + list(opts))
        out.append(c)
    return out


def seeded_variables(jcfg, seed: int = 0, canvas=(64, 64)):
    """The JAX FasterRCNN's {"params", "batch_stats"} at the shapes of its
    init (jax.eval_shape: traced, not run), filled with seeded values:
    weights normal(0, 0.05), running means normal(0, 0.1), variances
    uniform(0.5, 2), FrozenBN scales uniform(0.5, 1.5)."""
    shapes = jax.eval_shape(
        lambda: JaxFasterRCNN(jax_lower(jcfg)).init(jax.random.key(0), jnp.zeros((1, *canvas, 3), jnp.float32)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return rs.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name == "var":
            return rs.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rs.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.mark.parametrize("depth", [50, 101])
@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_state_dict_from_jax_equals_export(depth, norm):
    pc, jc = cfg_pair("MODEL.RESNETS.DEPTH", str(depth), "MODEL.RESNETS.NORM", norm)
    variables = seeded_variables(jc, seed=depth)
    pcfg = detector_config_from_cfg(pc)
    got = state_dict_from_jax(variables, pcfg)
    want = export_torch_checkpoint(variables["params"], variables["batch_stats"], jax_lower(jc))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = FasterRCNN(pcfg)
    model.load_state_dict(got, strict=True)
    blocks = sum(BLOCK_COUNTS[depth][:3])
    convs = [k for k in got if k.startswith("backbone.") and k.endswith(("conv1.weight", "conv2.weight", "conv3.weight",
                                                                            "shortcut.weight"))]
    assert len(convs) == 1 + 3 * blocks + 3  # stem, three per block, a shortcut per stage
    norm_type = FrozenBatchNorm2d if norm == "FrozenBN" else BatchNorm2d
    assert sum(isinstance(m, norm_type) for m in model.modules()) == len(convs)
    assert not any(k.startswith("backbone.res5") for k in got)
    if norm == "FrozenBN":  # the affine is buffers: no parameter of the backbone is a norm's
        assert not [n for n, _ in model.named_parameters() if ".norm." in n]


def test_frozen_bn_loads_detectron2_keys_without_counter():
    """A Detectron2 FrozenBatchNorm2d writes no num_batches_tracked; the
    JAX exporter writes one. Both load strictly."""
    m = FrozenBatchNorm2d(4)
    sd = {"weight": torch.rand(4), "bias": torch.rand(4), "running_mean": torch.rand(4), "running_var": torch.rand(4)}
    m.load_state_dict(sd, strict=True)
    assert all(torch.equal(getattr(m, k), v) for k, v in sd.items())
    m.load_state_dict({**sd, "num_batches_tracked": torch.tensor(0)}, strict=True)


@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_features_match_jax_at_depth_50(norm):
    pc, jc = cfg_pair("MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.NORM", norm, "TPU.CANVAS", str(CANVAS))
    variables = seeded_variables(jc, seed=1)
    pcfg = detector_config_from_cfg(pc)
    images = np.random.RandomState(2).randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    jmodel = JaxFasterRCNN(jax_lower(jc))
    for train in (False, True):
        model = FasterRCNN(pcfg)
        model.load_state_dict(state_dict_from_jax(variables, pcfg), strict=True)
        want, updated = jmodel.apply(variables, jnp.asarray(images), train, method="features", mutable=["batch_stats"])
        with torch.no_grad():
            got = model.features(torch.from_numpy(images), train=train)
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert got.shape == want.shape == (2, 1024, CANVAS[0] // 16, CANVAS[1] // 16)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= (1e-3 if train and norm == "BN" else 1e-5), (train, err)

        stats_want = state_dict_from_jax({"params": variables["params"], "batch_stats": updated["batch_stats"]}, pcfg)
        stats_start = state_dict_from_jax(variables, pcfg)
        got_sd = model.state_dict()
        moved = 0
        for k, w in stats_want.items():
            if not k.endswith(("running_mean", "running_var")):
                continue
            w = w.numpy()
            tol = 1e-6 if k.startswith("backbone.stem.") else 1e-4
            np.testing.assert_allclose(got_sd[k].numpy(), w, rtol=0, atol=tol * np.abs(w).max(), err_msg=k)
            moved += not np.array_equal(w, stats_start[k].numpy())
        # train-mode BN moves every layer's statistics (stem and res2 too);
        # FrozenBN and eval mode move none
        assert moved == (2 * 43 if train and norm == "BN" else 0), moved  # 43 norms: stem, 39 in blocks, 3 shortcuts


def test_resnet_backbone_stops_at_the_deepest_stage():
    net = ResNetBackbone(depth=50, norm="FrozenBN", out_features=("res3",))
    assert net.stages == ["res2", "res3"] and not hasattr(net, "res4")
    feats = net(torch.zeros(1, 3, 64, 96))
    assert {k: tuple(v.shape) for k, v in feats.items()} == {"res2": (1, 256, 16, 24), "res3": (1, 512, 8, 12)}
    with pytest.raises(NotImplementedError, match="GN"):
        ResNetBackbone(depth=50, norm="GN")


def test_frozen_bn_output_is_float32_under_bfloat16_as_in_jax():
    """bf16 conv output x float32 FrozenBN affine -> float32, as flax's
    x * inv + (bias - mean * inv) promotes; so the residual add and the
    res4 feature are float32 under FrozenBN."""
    m = FrozenBatchNorm2d(3)
    assert m(torch.ones(1, 3, 2, 2, dtype=torch.bfloat16)).dtype == torch.float32
    net = ResNetBackbone(depth=50, norm="FrozenBN")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert net(torch.zeros(1, 3, 64, 64))["res4"].dtype == torch.float32


@pytest.mark.parametrize("name", R101_YAMLS)
def test_r101_yamls_lower_as_in_jax_and_build(tmp_path, monkeypatch, name):
    """Every R101 YAML: the same DetectorConfig as the JAX package's
    lowering, field for field, and its trainer builds on the CPU (a cut
    block plan and a narrow box head, so that building stays cheap)."""
    assert len(R101_YAMLS) == 10
    pc, jc = get_cfg(), jax_get_cfg()
    for c in (pc, jc):
        c.merge_from_file(os.path.join(ROOT, "configs", name))
    ours, want = dataclasses.asdict(detector_config_from_cfg(pc)), dataclasses.asdict(jax_lower(jc))
    assert ours.pop("dtype") == torch.bfloat16 and want.pop("dtype") == jnp.bfloat16
    assert ours == want
    assert ours["backbone"] == "resnet101" and ours["in_feature"] == "res4" and ours["rpn_pre_nms_topk_test"] == 4096
    monkeypatch.setitem(BLOCK_COUNTS, 101, (1, 1, 1, 1))
    pc.merge_from_list(SMALL + ["OUTPUT_DIR", str(tmp_path)])
    tr = build_trainer(pc, device="cpu")
    assert tr.det_cfg.feature_channels == 1024 and tr.det_cfg.stride == 16
    if pc.SEMISUPNET.DIS_TYPE == "res4" and pc.DOMAIN_CLASSIFIER.ENABLED:
        assert tr.state.dc["dc"].conv1.weight.shape[1] == 1024


def test_jax_reset_bn_zeroes_frozen_bn_statistics():
    """The JAX package's reset_bn_tree resets every leaf named mean/var, the
    FrozenBN statistics included (simple_sfod_tpu/engine/trainers/base.py:
    646-656): after AdaBN a FrozenBN layer normalises with mean 0 and var 1
    for good, since it never updates them. Pinned as a known fault of the
    reference; the port's reset_bn_stats leaves FrozenBN as loaded
    (test_torch_adabn.py::test_reset_bn_stats_leaves_frozen_bn_as_loaded)."""
    _, jc = cfg_pair("MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.NORM", "FrozenBN")
    stats = seeded_variables(jc)["batch_stats"]
    reset = reset_bn_tree(stats)
    stem = reset["backbone"]["stem_norm"]
    assert not np.any(np.asarray(stem["mean"])) and np.all(np.asarray(stem["var"]) == 1.0)
    assert np.any(stats["backbone"]["stem_norm"]["mean"])


def test_ema_blends_every_leaf_the_jax_package_blends():
    """The JAX EMA maps over the whole params and batch_stats trees, a
    FrozenBN's scale, bias, mean and var included; the port's ema_tensors
    hold as many tensors, with FrozenBN's affine among them (buffers here)."""
    from simple_sfod_tpu_torch.engine.train_state import ema_tensors

    pc, jc = cfg_pair("MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.NORM", "FrozenBN")
    variables = seeded_variables(jc)
    model = FasterRCNN(detector_config_from_cfg(pc))
    got = ema_tensors(model)
    assert len(got) == len(jax.tree_util.tree_leaves(variables))
    stem = model.backbone.stem.conv1.norm
    for t in (stem.weight, stem.bias, stem.running_mean, stem.running_var):
        assert any(g is t for g in got)
