"""Default config and its lowering to a DetectorConfig (the port's copy of
`simple_sfod_tpu/config/defaults.py`).

`get_cfg` holds every key and default of the JAX package's config, so the
YAML files under `configs/` merge unchanged. Two configurations are also
kept as Python values, so that they build without reading YAML (the GPU
smoke run uses them; a CPU test holds each to `merge_from_file`):

  MAIN_CONFIG    configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml
                 (`get_main_cfg()`, served and adapted)
  SOURCE_CONFIG  configs/faster_rcnn_VGG_cityscapes_source_new.yaml
                 (`get_source_cfg()`, supervised source training)

and the adaptation benchmark's configuration, `SFAT_BENCH_CONFIG`
(`get_sfat_bench_cfg()`), which has no YAML.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.faster_rcnn import DetectorConfig
from .cfg_node import CfgNode


def get_cfg() -> CfgNode:
    """Every key and default of the JAX package's `get_cfg`, with the same
    names and values (what each key means is documented there)."""
    c = CfgNode()
    c.VERSION = 2
    c.SEED = -1
    c.OUTPUT_DIR = "./output"
    c.VIS_PERIOD = 0
    c.TRAINER = ""

    c.MODEL = CfgNode()
    c.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    c.MODEL.WEIGHTS = ""
    c.MODEL.MASK_ON = False
    c.MODEL.DEVICE = "tpu"
    c.MODEL.PIXEL_MEAN = (103.530, 116.280, 123.675)
    c.MODEL.PIXEL_STD = (1.0, 1.0, 1.0)

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    c.MODEL.BACKBONE.FREEZE_AT = 2

    c.MODEL.RESNETS = CfgNode()
    c.MODEL.RESNETS.DEPTH = 101
    c.MODEL.RESNETS.NORM = "FrozenBN"
    c.MODEL.RESNETS.OUT_FEATURES = ("res4",)

    c.MODEL.FPN = CfgNode()
    c.MODEL.FPN.IN_FEATURES = ()
    c.MODEL.FPN.OUT_CHANNELS = 256
    c.MODEL.FPN.NORM = ""
    c.MODEL.FPN.FUSE_TYPE = "sum"

    c.MODEL.ANCHOR_GENERATOR = CfgNode()
    c.MODEL.ANCHOR_GENERATOR.SIZES = ((32, 64, 128, 256, 512),)
    c.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = ((0.5, 1.0, 2.0),)

    c.MODEL.PROPOSAL_GENERATOR = CfgNode()
    c.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"

    c.MODEL.RPN = CfgNode()
    c.MODEL.RPN.IN_FEATURES = ("res4",)
    c.MODEL.RPN.NMS_THRESH = 0.7
    c.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    c.MODEL.RPN.POSITIVE_FRACTION = 0.5
    c.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    c.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    c.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    c.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    c.MODEL.RPN.LOSS_WEIGHT = 1.0
    c.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    c.MODEL.RPN.UNSUP_LOSS_WEIGHT = 1.0
    c.MODEL.RPN.LOSS = "CrossEntropy"

    c.MODEL.ROI_HEADS = CfgNode()
    c.MODEL.ROI_HEADS.NAME = "StandardROIHeads"
    c.MODEL.ROI_HEADS.IN_FEATURES = ("res4",)
    c.MODEL.ROI_HEADS.NUM_CLASSES = 80
    c.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    c.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    c.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    c.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    c.MODEL.ROI_HEADS.LOSS = "CrossEntropy"

    c.MODEL.ROI_BOX_HEAD = CfgNode()
    c.MODEL.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    c.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    c.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    c.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    c.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    c.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    c.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
    c.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    c.MODEL.ROI_BOX_HEAD.DROPOUT = 0.0

    c.INPUT = CfgNode()
    c.INPUT.MIN_SIZE_TRAIN = (600,)
    c.INPUT.MAX_SIZE_TRAIN = 1333
    c.INPUT.MIN_SIZE_TEST = 600
    c.INPUT.MAX_SIZE_TEST = 1333
    c.INPUT.FORMAT = "BGR"
    c.INPUT.RANDOM_FLIP = "horizontal"
    c.INPUT.MOSAIC = CfgNode()
    c.INPUT.MOSAIC.RANDOM_AFFINE = False
    c.INPUT.MOSAIC.DEGREES = 10.0
    c.INPUT.MOSAIC.TRANSLATE = 0.1
    c.INPUT.MOSAIC.SCALE = (0.5, 1.5)
    c.INPUT.MOSAIC.SHEAR = 2.0
    c.INPUT.MIXUP = CfgNode()
    c.INPUT.MIXUP.FLIP = True
    c.INPUT.MIXUP.SCALE_JITTER = ()

    c.DATASETS = CfgNode()
    c.DATASETS.TRAIN = ()
    c.DATASETS.TRAIN_TARGET = ()
    c.DATASETS.TEST = ()

    c.DATALOADER = CfgNode()
    c.DATALOADER.NUM_WORKERS = 4
    c.DATALOADER.SUP_PERCENT = 100.0
    c.DATALOADER.RANDOM_DATA_SEED = 0
    c.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    c.SOLVER = CfgNode()
    c.SOLVER.IMS_PER_BATCH = 16
    c.SOLVER.IMS_PER_BATCH_TARGET = 1
    c.SOLVER.BASE_LR = 0.001
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.FUSED = False
    c.SOLVER.WEIGHT_DECAY = 0.0001
    c.SOLVER.WEIGHT_DECAY_NORM = 0.0
    c.SOLVER.GAMMA = 0.1
    c.SOLVER.STEPS = (30000,)
    c.SOLVER.FACTOR_LIST = (1,)
    c.SOLVER.MAX_ITER = 40000
    c.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    c.SOLVER.WARMUP_ITERS = 1000
    c.SOLVER.WARMUP_METHOD = "linear"
    c.SOLVER.CHECKPOINT_PERIOD = 5000
    c.SOLVER.REFERENCE_WORLD_SIZE = 0
    c.SOLVER.CLIP_GRADIENTS = CfgNode()
    c.SOLVER.CLIP_GRADIENTS.ENABLED = False
    c.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    c.SOLVER.AMP = CfgNode()
    c.SOLVER.AMP.ENABLED = False

    c.TEST = CfgNode()
    c.TEST.EVAL_PERIOD = 0
    c.TEST.IMS_PER_BATCH = 1
    c.TEST.DETECTIONS_PER_IMAGE = 100
    c.TEST.VAL_LOSS = True
    c.TEST.EVALUATOR = "COCOeval"
    c.TEST.F1_MODE = "reference"
    c.TEST.PRECISE_BN = CfgNode()
    c.TEST.PRECISE_BN.ENABLED = False
    c.TEST.PRECISE_BN.NUM_ITER = 200

    c.VGG = CfgNode()
    c.VGG.BN = True

    c.DA_FASTER = CfgNode()
    c.DA_FASTER.DC_IMG_GRL_WEIGHT = 0.01
    c.DA_FASTER.DC_INS_GRL_WEIGHT = 0.1
    c.DA_FASTER.DC_CONSISTENCY_WEIGHT = 0.1
    c.DA_FASTER.LEVELS = ("res4",)
    c.DA_FASTER.ENTROPY_CONDITIONING = False

    c.SEMISUPNET = CfgNode()
    c.SEMISUPNET.MLP_DIM = 128
    c.SEMISUPNET.BBOX_THRESHOLD = 0.7
    c.SEMISUPNET.PSEUDO_BBOX_SAMPLE = "thresholding"
    c.SEMISUPNET.TEACHER_UPDATE_ITER = 1
    c.SEMISUPNET.BURN_UP_STEP = 12000
    c.SEMISUPNET.EMA_KEEP_RATE = 0.0
    c.SEMISUPNET.UNSUP_LOSS_WEIGHT = 4.0
    c.SEMISUPNET.SUP_LOSS_WEIGHT = 0.5
    c.SEMISUPNET.LOSS_WEIGHT_TYPE = "standard"
    c.SEMISUPNET.DIS_TYPE = "res4"
    c.SEMISUPNET.DIS_LOSS_WEIGHT = 0.1
    c.SEMISUPNET.INS_DC = False
    c.SEMISUPNET.SPLIT_VIEW_BN = False

    c.EMAMODEL = CfgNode()
    c.EMAMODEL.SUP_CONSIST = True

    c.ADAPTIVE_THRESHOLD = CfgNode()
    c.ADAPTIVE_THRESHOLD.ENABLED = True
    c.ADAPTIVE_THRESHOLD.WARM_UP = 100
    c.ADAPTIVE_THRESHOLD.RESERVE = 500

    c.WEAK_STRONG_AUGMENT = True
    c.ENHANCE = True

    c.DOMAIN_CLASSIFIER = CfgNode()
    c.DOMAIN_CLASSIFIER.ENABLED = False
    c.DOMAIN_CLASSIFIER.IMAGE = False
    c.DOMAIN_CLASSIFIER.INSTANCE = False

    c.STYLE = CfgNode()
    c.STYLE.ENABLED = False
    c.STYLE.STYLE_IMAGE = None
    c.STYLE.VGG_MODEL = None
    c.STYLE.DECODER = None
    c.STYLE.ALPHA = 0.4

    c.TPU = CfgNode()
    c.TPU.CANVAS = (608, 1216)
    c.TPU.GT_CAPACITY = 64
    c.TPU.DTYPE = "float32"
    c.TPU.MESH_DATA = -1
    c.TPU.MESH_MODEL = 1
    c.TPU.SPATIAL_SHARD = False
    c.TPU.STEPS_PER_DISPATCH = 1
    c.TPU.EVAL_PIPELINE_DEPTH = 4
    c.TPU.CHUNK_STAGE_AHEAD = 1

    return c



# The main configuration's YAML as Python values. Keep in step with the file
# (tests/test_torch_config.py compares the two merged trees).
MAIN_CONFIG_NAME = "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml"
MAIN_CONFIG: Dict[str, Any] = {
    "MODEL": {
        "META_ARCHITECTURE": "SourceFreeAdaptiveTeacherGeneralizedRCNN",
        "WEIGHTS": "",
        "BACKBONE": {"NAME": "build_vgg_backbone"},
        "ROI_HEADS": {
            "IN_FEATURES": ("vgg4",),
            "NAME": "SourceFreeAdaptiveTeacherStandardROIHeads",
            "NUM_CLASSES": 8,
        },
        "ROI_BOX_HEAD": {"NAME": "FastRCNNConvFCHead", "NUM_FC": 2, "POOLER_RESOLUTION": 7},
        "RPN": {"IN_FEATURES": ("vgg4",), "PRE_NMS_TOPK_TEST": 6000, "POST_NMS_TOPK_TEST": 1000},
        "PROPOSAL_GENERATOR": {"NAME": "PseudoLabRPN"},
    },
    "INPUT": {"MIN_SIZE_TRAIN": (600,), "MIN_SIZE_TEST": 600},
    "OUTPUT_DIR": "./output/cityscape_new_mean_teacher_nowq",
    "DATASETS": {
        "TRAIN_TARGET": ("cityscapes_instancesonly_foggy_train_foggy_beta_0.02",),
        "TEST": ("cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02"),
    },
    "SOLVER": {
        "STEPS": (60000, 80000, 90000, 360000),
        "FACTOR_LIST": (1, 1, 1, 1, 1),
        "MAX_ITER": 100000,
        "WARMUP_ITERS": 1000,
        "CHECKPOINT_PERIOD": 2000,
        "IMS_PER_BATCH": 1,
        "IMS_PER_BATCH_TARGET": 1,
        "BASE_LR": 0.0025,
    },
    "TEST": {"EVAL_PERIOD": 10, "IMS_PER_BATCH": 1},
    "DATALOADER": {"SUP_PERCENT": 100.0},
    "SEMISUPNET": {
        "BBOX_THRESHOLD": 0.8,
        "TEACHER_UPDATE_ITER": 1,
        "BURN_UP_STEP": 2000,
        "EMA_KEEP_RATE": 0.9996,
        "UNSUP_LOSS_WEIGHT": 1.0,
        "SUP_LOSS_WEIGHT": 1.0,
        "DIS_TYPE": "vgg4",
        "INS_DC": True,
    },
    "VIS_PERIOD": 100,
    "SEED": 42,
    "ADAPTIVE_THRESHOLD": {"ENABLED": False, "WARM_UP": 100, "RESERVE": 500},
    "STYLE": {"ENABLED": False},
    "WEAK_STRONG_AUGMENT": False,
    "ENHANCE": False,
    "DOMAIN_CLASSIFIER": {"ENABLED": True, "IMAGE": False, "INSTANCE": False},
    "TPU": {"CANVAS": (608, 1216), "DTYPE": "bfloat16"},
    "TRAINER": "source_free_adaptive_teacher",
    "VGG": {"BN": True},
}


# configs/faster_rcnn_VGG_cityscapes_source_new.yaml as Python values; kept
# in step with the file like MAIN_CONFIG.
SOURCE_CONFIG_NAME = "faster_rcnn_VGG_cityscapes_source_new.yaml"
SOURCE_CONFIG: Dict[str, Any] = {
    "MODEL": {
        "META_ARCHITECTURE": "GeneralizedRCNN",
        "WEIGHTS": "",
        "BACKBONE": {"NAME": "build_vgg_backbone"},
        "ROI_HEADS": {"IN_FEATURES": ("vgg4",), "NAME": "StandardROIHeads", "NUM_CLASSES": 8},
        "ROI_BOX_HEAD": {"NAME": "FastRCNNConvFCHead", "NUM_FC": 2, "POOLER_RESOLUTION": 7},
        "RPN": {"IN_FEATURES": ("vgg4",), "PRE_NMS_TOPK_TEST": 6000, "POST_NMS_TOPK_TEST": 1000},
    },
    "INPUT": {"MIN_SIZE_TRAIN": (600,), "MIN_SIZE_TEST": 600},
    "OUTPUT_DIR": "./output/train_cityscape_vgg_base",
    "DATASETS": {
        "TRAIN": ("cityscapes_instancesonly_train",),
        "TRAIN_TARGET": ("cityscapes_instancesonly_foggy_train_foggy_beta_0.02",),
        "TEST": ("cityscapes_instancesonly_val", "cityscapes_instancesonly_foggy_val_foggy_beta_0.02"),
    },
    "SOLVER": {
        "STEPS": (60000, 80000, 90000, 360000),
        "FACTOR_LIST": (1, 1, 1, 1, 1),
        "MAX_ITER": 100000,
        "WARMUP_ITERS": 1000,
        "CHECKPOINT_PERIOD": 1000,
        "IMS_PER_BATCH": 1,
        "BASE_LR": 0.04,
    },
    "TEST": {"EVAL_PERIOD": 1000, "IMS_PER_BATCH": 1},
    "TPU": {"CANVAS": (608, 1216)},
    "VIS_PERIOD": 1000,
    "SEED": 42,
    "TRAINER": "base",
}


# The adaptation benchmark's configuration: the port's copy of
# `simple_sfod_tpu/utils/bench.py:sfat_bench_cfg`, on get_cfg's defaults
# (WEAK_STRONG_AUGMENT and ADAPTIVE_THRESHOLD.ENABLED on, domain classifiers
# off): the main SFAT step on VGG16-BN, 8 classes, bfloat16 at 608x1216,
# batch 1, BBOX_THRESHOLD 0.8 and EMA keep rate 0.9996 as the main YAML.
SFAT_BENCH_CONFIG: Dict[str, Any] = {
    "TRAINER": "source_free_adaptive_teacher",
    "MODEL": {
        "BACKBONE": {"NAME": "build_vgg_backbone"},
        "RPN": {"IN_FEATURES": ("vgg4",)},
        "ROI_HEADS": {"IN_FEATURES": ("vgg4",), "NUM_CLASSES": 8},
    },
    "VGG": {"BN": True},
    "SEMISUPNET": {"BBOX_THRESHOLD": 0.8, "EMA_KEEP_RATE": 0.9996},
    "SOLVER": {"IMS_PER_BATCH_TARGET": 1, "CHECKPOINT_PERIOD": 0},
    "TPU": {"CANVAS": (608, 1216), "DTYPE": "bfloat16"},
    "SEED": 0,
    "TEST": {"EVAL_PERIOD": 0},
}


def get_sfat_bench_cfg(output_dir: str = "./output/sfat_bench") -> CfgNode:
    """The adaptation benchmark's configuration at its defaults (batch 1,
    the main variant), frozen, writing to `output_dir`:
    `utils/bench.py:sfat_bench_cfg`."""
    from ..utils.bench import sfat_bench_cfg

    return sfat_bench_cfg(output_dir=output_dir)


def config_opts(tree: Dict[str, Any], prefix: str = "") -> List[str]:
    """Flatten a nested key dict to `merge_from_list`'s KEY VALUE pairs."""
    opts: List[str] = []
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            opts += config_opts(v, key + ".")
        else:
            opts += [key, repr(v)]
    return opts


def get_main_cfg() -> CfgNode:
    """The main configuration, built from `MAIN_CONFIG` without YAML."""
    cfg = get_cfg()
    cfg.merge_from_list(config_opts(MAIN_CONFIG))
    return cfg


def get_source_cfg() -> CfgNode:
    """The supervised source-training configuration, built from
    `SOURCE_CONFIG` without YAML."""
    cfg = get_cfg()
    cfg.merge_from_list(config_opts(SOURCE_CONFIG))
    return cfg


_BACKBONE_MAP = {
    "build_vgg_backbone": "vgg16",
    "build_vgg_fpn_backbone": "vgg16",
    "build_resnet_backbone": None,  # resolved from RESNETS.DEPTH
    "build_tiny_backbone": "tiny",
}


def detector_config_from_cfg(cfg: CfgNode) -> DetectorConfig:
    """Lower the yacs-style CfgNode to the static DetectorConfig, with the
    same caps as the JAX package (pre-NMS 4096, post-NMS 2048/1024) and
    `TPU.DTYPE`/`SOLVER.AMP` mapped to torch.bfloat16/torch.float32."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONE_MAP:
        raise ValueError(f"unknown backbone {name}")
    backbone = _BACKBONE_MAP[name] or f"resnet{cfg.MODEL.RESNETS.DEPTH}"
    in_feature = cfg.MODEL.ROI_HEADS.IN_FEATURES[0]
    # unsupported-but-settable keys fail loudly instead of silently diverging
    if cfg.MODEL.ROI_BOX_HEAD.NUM_CONV:
        raise ValueError("MODEL.ROI_BOX_HEAD.NUM_CONV > 0 is not supported (reference heads are FC-only)")
    if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG:
        raise ValueError("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG is not supported")
    if cfg.MODEL.PROPOSAL_GENERATOR.NAME not in ("RPN", "PseudoLabRPN"):
        # PseudoLabRPN (the reference's loss-free RPN forward) is subsumed by
        # `propose()` without `rpn_losses()` — both names lower identically
        raise ValueError(
            f"unknown MODEL.PROPOSAL_GENERATOR.NAME {cfg.MODEL.PROPOSAL_GENERATOR.NAME!r} "
            "(supported: RPN, PseudoLabRPN)"
        )
    fpn = name.endswith("_fpn_backbone")
    rpn_in_features: tuple = ()
    roi_in_features: tuple = ()
    anchor_sizes_per_level: tuple = ()
    sizes = tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES)
    if fpn:
        # d2 FPN-config defaults (Base-RCNN-FPN.yaml) when the YAML leaves
        # the single-level defaults in place: RPN over p2..p6, ROI pooling
        # over p2..p5, one anchor size per RPN level.
        rpn_in = tuple(cfg.MODEL.RPN.IN_FEATURES)
        roi_in = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        rpn_in_features = (
            ("p2", "p3", "p4", "p5", "p6") if rpn_in == ("res4",) else rpn_in
        )
        roi_in_features = (
            ("p2", "p3", "p4", "p5") if roi_in == ("res4",) else roi_in
        )
        bad = [f for f in rpn_in_features + roi_in_features if not f.startswith("p")]
        if bad:
            raise ValueError(
                f"{name} produces pyramid levels p2..p6; MODEL.RPN.IN_FEATURES/"
                f"MODEL.ROI_HEADS.IN_FEATURES must name them (got {bad})"
            )
        in_feature = roi_in_features[0]
        if len(sizes) == len(rpn_in_features):
            anchor_sizes_per_level = sizes  # d2 per-level SIZES=[[32],[64],...]
        elif len(sizes) == 1 and rpn_in == ("res4",) and len(sizes[0]) == len(rpn_in_features):
            # defaulted FPN levels + defaulted global 5-size list -> the
            # standard d2 FPN split, one size per level
            anchor_sizes_per_level = tuple((s,) for s in sizes[0])
        elif len(sizes) == 1:
            anchor_sizes_per_level = tuple(sizes[0] for _ in rpn_in_features)
        else:
            raise ValueError(
                f"ANCHOR_GENERATOR.SIZES has {len(sizes)} entries for "
                f"{len(rpn_in_features)} RPN levels (need 1 or {len(rpn_in_features)})"
            )
    fpn_in_features = tuple(cfg.MODEL.FPN.IN_FEATURES)
    if fpn and not fpn_in_features:
        fpn_in_features = (
            ("vgg1", "vgg2", "vgg3", "vgg4")
            if backbone == "vgg16"
            else ("res2", "res3", "res4", "res5")
        )
    dtype = torch.bfloat16 if (cfg.TPU.DTYPE == "bfloat16" or cfg.SOLVER.AMP.ENABLED) else torch.float32
    return DetectorConfig(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        backbone=backbone,
        vgg_bn=cfg.VGG.BN,
        resnet_norm=cfg.MODEL.RESNETS.NORM,
        in_feature=in_feature,
        fpn=fpn,
        fpn_in_features=fpn_in_features,
        fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        fpn_norm=cfg.MODEL.FPN.NORM,
        fpn_fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        rpn_in_features=rpn_in_features,
        roi_in_features=roi_in_features,
        anchor_sizes_per_level=anchor_sizes_per_level,
        anchor_sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
        anchor_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        rpn_pre_nms_topk_train=min(cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN, 4096),
        rpn_post_nms_topk_train=min(cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, 2048),
        rpn_pre_nms_topk_test=min(cfg.MODEL.RPN.PRE_NMS_TOPK_TEST, 4096),
        rpn_post_nms_topk_test=min(cfg.MODEL.RPN.POST_NMS_TOPK_TEST, 1024),
        rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
        rpn_batch_size_per_image=cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=cfg.MODEL.RPN.POSITIVE_FRACTION,
        rpn_smooth_l1_beta=cfg.MODEL.RPN.SMOOTH_L1_BETA,
        rpn_loss_weight=cfg.MODEL.RPN.LOSS_WEIGHT,
        roi_batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        fc_dim=cfg.MODEL.ROI_BOX_HEAD.FC_DIM,
        num_fc=cfg.MODEL.ROI_BOX_HEAD.NUM_FC,
        box_head_dropout=cfg.MODEL.ROI_BOX_HEAD.DROPOUT,
        score_thresh_test=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        dtype=dtype,
    )
