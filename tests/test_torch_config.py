"""The port's config (simple_sfod_tpu_torch/config) against the JAX
package's: every YAML under configs/ merges to the same key tree and lowers
to the same DetectorConfig, and the main configuration built from Python
keys equals merge_from_file of its YAML."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu_torch.config import MAIN_CONFIG, detector_config_from_cfg, get_cfg, get_main_cfg
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
    ours, theirs = both(path)
    assert plain(ours) == plain(theirs)


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
