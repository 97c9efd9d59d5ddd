"""Dataset registry (the port's copy of `simple_sfod_tpu/data/datasets.py`).

Names as the reference registers them: `cityscapes_instancesonly_{split}`,
`cityscapes_instancesonly_foggy_{split}_{fog}` (the `_adabn` spliced files
included), `cityscapes_car_{split}`, `sim10k_{split}` and `kitti_{split}`
resolve to COCO-JSON files, `clipart_`, `comic_` and `watercolor_{split}` to
Pascal-VOC XML trees (data/voc.py), all under a dataset root: the
environment's `SFOD_DATASETS`, else `DETECTRON2_DATASETS`, else `datasets`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .coco import load_coco_json

DATASET_REGISTRY: Dict[str, dict] = {}

CITYSCAPES_THING_CLASSES = [
    "person",
    "rider",
    "car",
    "truck",
    "bus",
    "train",
    "motorcycle",
    "bicycle",
]


def _root() -> str:
    return os.environ.get("SFOD_DATASETS", os.environ.get("DETECTRON2_DATASETS", "datasets"))


def register_dataset(
    name: str,
    json_file: str,
    image_root: str,
    thing_classes: Optional[list] = None,
    class_remap: Optional[dict] = None,
):
    """class_remap: optional {contiguous_id -> new_id} that the COCO
    evaluator applies to predictions (the car-only Sim10k/KITTI ->
    Cityscapes evaluations; evaluation/build.py)."""
    DATASET_REGISTRY[name] = {
        "name": name,
        "json_file": json_file,
        "image_root": image_root,
        "thing_classes": thing_classes,
        "class_remap": class_remap,
        "_cache": None,
    }


def register_voc_dataset(name: str, dirname: str, split: str, thing_classes: list):
    """A Pascal-VOC XML dataset (clipart, comic, watercolor)."""
    DATASET_REGISTRY[name] = {
        "name": name,
        "json_file": None,
        "voc_dirname": dirname,
        "voc_split": split,
        "image_root": os.path.join(dirname, "JPEGImages"),
        "thing_classes": thing_classes,
        "class_remap": None,
        "_cache": None,
    }


def get_dataset(name: str) -> dict:
    """Resolve and load (once) a registered dataset; returns the registry
    entry with 'records' and 'thing_classes' filled in."""
    if name not in DATASET_REGISTRY:
        register_all_datasets()
    if name not in DATASET_REGISTRY:
        _register_by_pattern(name)
    if name not in DATASET_REGISTRY:
        raise KeyError(f"dataset {name!r} is not registered")
    entry = DATASET_REGISTRY[name]
    if entry["_cache"] is None:
        if entry.get("voc_split") is not None:
            from .voc import load_voc_instances

            data = load_voc_instances(entry["voc_dirname"], entry["voc_split"], entry["thing_classes"])
        else:
            data = load_coco_json(entry["json_file"], entry["image_root"])
            if entry["thing_classes"]:
                data["thing_classes"] = entry["thing_classes"]
        entry["_cache"] = data
    entry.update(entry["_cache"])
    return entry


def _register_by_pattern(name: str, root: Optional[str] = None):
    """Registration by name for splits that register_all_datasets does not
    list: the cityscapes/foggy/sim10k/kitti families resolve to their
    conventional JSON paths under the root, the VOC families (split after
    the last underscore) to their XML trees."""
    root = root or _root()
    if name.startswith("cityscapes_instancesonly_foggy_"):
        split_fog = name[len("cityscapes_instancesonly_foggy_"):]
        base = os.path.join(root, "cityscapes_foggy")
        register_dataset(
            name,
            os.path.join(base, "annotations", f"instancesonly_filtered_gtFine_{split_fog}.json"),
            base,
            CITYSCAPES_THING_CLASSES,
        )
    elif name.startswith("cityscapes_instancesonly_"):
        split = name[len("cityscapes_instancesonly_"):]
        base = os.path.join(root, "cityscapes")
        register_dataset(
            name,
            os.path.join(base, "annotations", f"instancesonly_filtered_gtFine_{split}.json"),
            base,
            CITYSCAPES_THING_CLASSES,
        )
    elif name.startswith("cityscapes_car_"):
        # car-only ground truth for the Sim10k/KITTI -> Cityscapes protocol
        split = name[len("cityscapes_car_"):]
        base = os.path.join(root, "cityscapes")
        register_dataset(
            name,
            os.path.join(base, "annotations", f"caronly_filtered_gtFine_{split}.json"),
            base,
            ["car"],
        )
    elif name.startswith("sim10k_"):
        split = name[len("sim10k_"):]
        base = os.path.join(root, "sim10k")
        register_dataset(name, os.path.join(base, f"sim10k_coco_{split}.json"), base, ["car"])
    elif name.startswith("kitti_"):
        split = name[len("kitti_"):]
        base = os.path.join(root, "kitti")
        register_dataset(name, os.path.join(base, f"kitti_{split}_coco_format.json"), base, ["car"])
    elif name.startswith(("clipart_", "comic_", "watercolor_")):
        # clipart has the 20 VOC classes, comic and watercolor the 6 of VOC6
        from .voc import VOC6_CLASS_NAMES, VOC_CLASS_NAMES

        ds, split = name.rsplit("_", 1)
        classes = VOC_CLASS_NAMES if ds == "clipart" else VOC6_CLASS_NAMES
        register_voc_dataset(name, os.path.join(root, ds), split, classes)


def register_all_datasets(root: Optional[str] = None):
    """Register the reference's dataset names under `root` (names already
    registered stay as they are)."""
    root = root or _root()
    cs = os.path.join(root, "cityscapes")
    cs_foggy = os.path.join(root, "cityscapes_foggy")

    def reg(name, base, json_rel, img_rel, classes=CITYSCAPES_THING_CLASSES):
        if name not in DATASET_REGISTRY:
            register_dataset(name, os.path.join(base, json_rel), os.path.join(base, img_rel), classes)

    # the image root is the dataset's base directory: the annotations'
    # file names carry the leftImg8bit*/split/... sub-path themselves
    for split in ("train", "val", "test"):
        reg(
            f"cityscapes_instancesonly_{split}",
            cs,
            f"annotations/instancesonly_filtered_gtFine_{split}.json",
            "",
        )
        for beta in ("0.02", "0.01", "0.005"):
            reg(
                f"cityscapes_instancesonly_foggy_{split}_foggy_beta_{beta}",
                cs_foggy,
                f"annotations/instancesonly_filtered_gtFine_{split}_foggy_beta_{beta}.json",
                "",
            )
        # the AdaBN / fixed-pseudo-label annotation files, re-registered as
        # ground truth after prediction_to_gt
        reg(
            f"cityscapes_instancesonly_foggy_{split}_adabn",
            cs_foggy,
            f"annotations/instancesonly_filtered_gtFine_{split}_adabn.json",
            "",
        )

    sim = os.path.join(root, "sim10k")
    if "sim10k_trainval" not in DATASET_REGISTRY:
        register_dataset(
            "sim10k_trainval",
            os.path.join(sim, "annotations/sim10k_trainval.json"),
            os.path.join(sim, "JPEGImages"),
            ["car"],
        )
    kitti = os.path.join(root, "kitti")
    if "kitti_train" not in DATASET_REGISTRY:
        register_dataset(
            "kitti_train",
            os.path.join(kitti, "annotations/kitti_train.json"),
            os.path.join(kitti, "training/image_2"),
            ["car"],
        )
    from .voc import VOC6_CLASS_NAMES, VOC_CLASS_NAMES

    for name in ("clipart", "comic", "watercolor"):
        classes = VOC_CLASS_NAMES if name == "clipart" else VOC6_CLASS_NAMES
        for split in ("train", "test", "traintest"):
            key = f"{name}_{split}"
            if key not in DATASET_REGISTRY:
                register_voc_dataset(key, os.path.join(root, name), split, classes)
