"""The port's config (simple_sfod_tpu_torch/config) against the JAX
package's: every YAML under configs/ merges to the same key tree and lowers
to the same DetectorConfig, and the main configuration built from Python
keys equals merge_from_file of its YAML. The port's YAML reader
(config/yaml_subset.py) gives what yaml.safe_load gives on every file
under configs/ and on the subset's scalars, and refuses, naming the line,
what lies outside the subset."""

import dataclasses
import glob
import math
import os

import jax.numpy as jnp
import pytest
import torch
import yaml

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu_torch.config import MAIN_CONFIG, detector_config_from_cfg, get_cfg, get_main_cfg, yaml_subset
from simple_sfod_tpu_torch.config.cfg_node import SWITCH_NODES
from simple_sfod_tpu_torch.config.defaults import MAIN_CONFIG_NAME, config_opts

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))
IDS = [os.path.basename(p) for p in CONFIGS]


def plain(node):
    return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def both(path):
    ours, theirs = get_cfg(), jax_get_cfg()
    ours.merge_from_file(path)
    theirs.merge_from_file(path)
    return ours, theirs


def test_defaults_equal():
    assert plain(get_cfg()) == plain(jax_get_cfg())


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_yaml_merges_to_equal_tree(path):
    """Equal trees, except where a YAML gives a SWITCH_NODES node as one
    bool: the JAX package keeps the bool in place of the node (its trainer
    then raises), the port sets the node's switch to it and its other bool
    keys off (test_torch_sfat_trainer.py::test_domain_classifier_given_as_bool_builds_and_steps)."""
    ours, theirs = both(path)
    want = plain(theirs)
    for key, switch in SWITCH_NODES.items():
        if isinstance(want[key], bool):
            want[key] = {k: want[key] if k == switch else (False if isinstance(v, bool) else v)
                         for k, v in ours[key].items()}
    assert plain(ours) == want


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_yaml_lowers_to_equal_detector_config(path):
    ours, theirs = both(path)
    a, b = detector_config_from_cfg(ours), jax_lower(theirs)
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    da, db = fa.pop("dtype"), fb.pop("dtype")
    assert fa == fb
    assert (da == torch.bfloat16) == (db == jnp.bfloat16)
    assert (da == torch.float32) == (db == jnp.float32)


def test_main_config_from_python_keys_equals_yaml():
    from_yaml = get_cfg()
    from_yaml.merge_from_file(os.path.join(CONFIG_DIR, MAIN_CONFIG_NAME))
    assert plain(get_main_cfg()) == plain(from_yaml)
    det = detector_config_from_cfg(get_main_cfg())
    assert det.dtype == torch.bfloat16 and det.num_classes == 8 and det.stride == 32
    assert det.rpn_pre_nms_topk_test == 4096 and det.rpn_post_nms_topk_test == 1000


def test_config_opts_round_trip():
    cfg = get_cfg()
    cfg.merge_from_list(config_opts({"TPU": {"CANVAS": (64, 128)}, "MODEL": {"RPN": {"NMS_THRESH": 0.6}}}))
    assert cfg.TPU.CANVAS == (64, 128) and cfg.MODEL.RPN.NMS_THRESH == 0.6
    assert MAIN_CONFIG["TPU"]["DTYPE"] == "bfloat16"


def same(a, b):
    """Equal values of equal types (bool is not int), NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert same(yaml_subset.load(path), want)


SCALARS = [
    "0", "-7", "+12", "1.0", "0.0025", "1.", "-.5", ".5", "1.0e-3", "1.5E+2", ".inf", "-.Inf", ".nan", "True", "false",
    "yes", "No", "ON", "off", "~", "null", "NULL", "1e-3", "08", "(608, 1216)", '("a", "b",)', "./output/x_1",
    "build_vgg_backbone", "[]", "[1, 2.5, [3, [x]], 'y']", "[ [ 64, 128 ] ]", "[a, b, ]", '"quoted # not a comment"',
    "'it''s'", '"tab\\there \\"q\\""', "plain # comment", "value   # comment with 'quotes'", "",
]


@pytest.mark.parametrize("value", SCALARS)
def test_reader_scalars_equal_safe_load(value):
    text = f"ROOT:\n  KEY: {value}\n  OTHER: 1\n"
    assert same(yaml_subset.loads(text), yaml.safe_load(text)), value


OUTSIDE = {
    "block sequence": "A:\n  - 1\n  - 2\n",
    "flow mapping": "A: {b: 1}\n",
    "anchor": "A: &x 1\n",
    "alias": "A: *x\n",
    "tag": "A: !!str 1\n",
    "block scalar": "A: |\n  text\n",
    "multi-line flow": "A: [1,\n  2]\n",
    "octal": "A: 0755\n",
    "hex": "A: 0x1F\n",
    "underscored int": "A: 1_000\n",
    "sexagesimal": "A: 1:30\n",
    "timestamp": "A: 2020-01-02\n",
    "document marker": "---\nA: 1\n",
    "bad indentation": "A:\n    B: 1\n  C: 2\n",
    "tab indentation": "A:\n\tB: 1\n",
    "duplicate key": "A: 1\nA: 2\n",
    "unterminated quote": "A: 'x\n",
}


@pytest.mark.parametrize("text", OUTSIDE.values(), ids=OUTSIDE.keys())
def test_reader_refuses_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"^cfg\.yaml:\d+: "):
        yaml_subset.loads(text, "cfg.yaml")


# the configs that stopped before the port had the bare VGG, FPN and AdaIN
ZOO_CONFIGS = [
    "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_test.yaml",  # STYLE.ENABLED
    "faster_rcnn_VGG_cityscapes_foggy_enhance.yaml",  # STYLE.ENABLED
    "faster_rcnn_VGG_cityscapes_foggy_source_nobn.yaml",  # VGG.BN False
    "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_nobn.yaml",  # VGG.BN False
    "vgg16_cityscapes_to_foggy_source.yaml",  # VGG.BN False
    "vgg16_fpn_cityscapes_to_foggy_source.yaml",  # FPN and VGG.BN False
    "synthetic_tiny_fpn.yaml",  # FPN
]


@pytest.mark.parametrize("name", ZOO_CONFIGS)
def test_zoo_config_builds_its_trainer(name, tmp_path, capsys):
    """get_cfg, merge_from_file, detector_config_from_cfg and
    build_trainer(cfg, device="cpu") at a 64x128 canvas (FC_DIM 64): each
    of these builds the detector its YAML names (the style view from the
    YAML's weights/ files, absent here, falls back with the JAX package's
    messages)."""
    from simple_sfod_tpu_torch.engine.trainers import build_trainer

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, name))
    cfg.merge_from_list(["TPU.CANVAS", "(64, 128)", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "OUTPUT_DIR", str(tmp_path)])
    det_cfg = detector_config_from_cfg(cfg)
    tr = build_trainer(cfg, device="cpu")
    assert tr.det_cfg == det_cfg and type(tr.detector.model.backbone).__name__ == ("FPN" if det_cfg.fpn else
                                                                                    "VGG16Backbone")
    assert bool(tr._batchnorms()) == (det_cfg.vgg_bn or det_cfg.fpn_norm == "BN")
    assert (getattr(tr, "style", None) is not None) == bool(cfg.STYLE.ENABLED)
    if cfg.STYLE.ENABLED:
        assert "[style]" in capsys.readouterr().out
