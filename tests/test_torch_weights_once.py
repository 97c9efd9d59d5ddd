"""A trainer's weights are written once: a Detector is built without
PyTorch's default initialisation (`models/faster_rcnn.py:empty_model`: the
modules on the meta device, then allocated), and `init_weights` or a strict
load writes every parameter and buffer. Held: for the tiny, VGG16-BN,
VGG16, ResNet-101 C4 and VGG-FPN builds at FC_DIM 64, the trainer's state is
bit for bit the state of the default-initialised module after
`init_weights` (the path before), `init_weights` leaves no entry of a
NaN-filled empty model unwritten, and a strict load into a Detector gives
the loaded tensors."""

import pytest
import torch

from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.config.defaults import SOURCE_CONFIG, config_opts
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import DetectorConfig, FasterRCNN, empty_model, init_weights

FPN = {"fpn": True, "fpn_in_features": ("vgg1", "vgg2", "vgg3", "vgg4"),
       "rpn_in_features": ("p2", "p3", "p4", "p5", "p6"), "roi_in_features": ("p2", "p3", "p4", "p5")}
BUILDS = {
    "tiny": {"backbone": "tiny", "in_feature": "tiny1"},
    "vgg16_bn": {},
    "vgg16": {"vgg_bn": False},
    "r101_c4": {"backbone": "resnet101", "in_feature": "res4", "pixel_mean": (103.53, 116.28, 123.675),
                "pixel_std": (57.375, 57.12, 58.395)},
    "fpn": FPN,
}


def det_cfg(build):
    return DetectorConfig(fc_dim=64, num_classes=4, **BUILDS[build])


@pytest.mark.parametrize("build", list(BUILDS))
def test_weights_written_once_equal_the_default_path(tmp_path, build):
    cfg = get_cfg()
    cfg.merge_from_list(config_opts(SOURCE_CONFIG) + ["SEED", "3", "OUTPUT_DIR", str(tmp_path)])
    got = BaseTrainer(cfg, device="cpu", det_cfg=det_cfg(build)).state.model.state_dict()
    want = init_weights(FasterRCNN(det_cfg(build)), 3).state_dict()
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k

    empty = empty_model(det_cfg(build))
    with torch.no_grad():
        for t in [*empty.parameters(), *empty.buffers()]:
            t.fill_(float("nan") if t.is_floating_point() else -1)
    written = init_weights(empty, 3).state_dict()
    for k, w in want.items():
        assert torch.equal(written[k], w), k

    loaded = Detector(det_cfg(build), "cpu").load_state_dict(want).model.state_dict()
    assert all(torch.equal(loaded[k], w) for k, w in want.items())

