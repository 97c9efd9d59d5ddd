"""The port's host data path against the JAX package's on the CPU: COCO-JSON
and VOC-XML records, the dataset registry's name families and root, the
native codec (decode and resize) against PIL and the JAX binding, and
DetectionLoader batches bit for bit, from the same records and seeds.

Every comparison is exact: records and registry entries equal, decoded and
resized pixels equal, and every array of every batch equal (uint8 canvases,
sizes, scales, GT, ids, file sizes). The JAX loader decodes files with its
own native codec (or PIL) and resizes with PIL or its native resample, all
bit-exact with PIL, so the two loaders must agree exactly.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from simple_sfod_tpu.data import datasets as JD
from simple_sfod_tpu.data import native_codec as jnc
from simple_sfod_tpu.data.coco import load_coco_json as jax_load_coco_json
from simple_sfod_tpu.data.loader import DetectionLoader as JaxLoader
from simple_sfod_tpu.data.loader import build_test_loader as jax_build_test_loader
from simple_sfod_tpu.data.loader import build_train_loader as jax_build_train_loader
from simple_sfod_tpu.data.loader import divide_label_unlabel as jax_divide
from simple_sfod_tpu.data.synthetic import register_synthetic as jax_register_synthetic
from simple_sfod_tpu.data.voc import VOC6_CLASS_NAMES, load_voc_instances as jax_load_voc
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu_torch import host_libs
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.data import datasets as PD
from simple_sfod_tpu_torch.data import native_codec as pnc
from simple_sfod_tpu_torch.data.coco import load_coco_json
from simple_sfod_tpu_torch.data.loader import (
    DetectionLoader,
    build_test_loader,
    build_train_loader,
    d2_output_shape,
    divide_label_unlabel,
)
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, register_synthetic, synthetic_image
from simple_sfod_tpu_torch.data.voc import load_voc_instances
from test_voc_datasets import COMIC_TRAIN, make_voc_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def registries(monkeypatch, tmp_path):
    """Both registries emptied, the dataset root at tmp_path; restored after."""
    saved = (dict(JD.DATASET_REGISTRY), dict(PD.DATASET_REGISTRY))
    JD.DATASET_REGISTRY.clear()
    PD.DATASET_REGISTRY.clear()
    monkeypatch.setenv("SFOD_DATASETS", str(tmp_path))
    yield tmp_path
    for reg, old in zip((JD.DATASET_REGISTRY, PD.DATASET_REGISTRY), saved):
        reg.clear()
        reg.update(old)


def write_coco(root, name, records, categories, extra_anns=()):
    """A COCO JSON of `records` (XYXY boxes, contiguous classes mapped onto
    `categories`' ids) plus raw `extra_anns`; returns its path."""
    images, anns = [], []
    for r in records:
        images.append({"id": r["image_id"], "file_name": r["file_name"], "height": r["height"], "width": r["width"]})
        for b, c in zip(r["boxes"], r["classes"]):
            anns.append({"id": len(anns) + 1, "image_id": r["image_id"], "category_id": categories[c]["id"],
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "iscrowd": 0})
    for a in extra_anns:
        anns.append(dict(a, id=len(anns) + 1))
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return path


def png_dataset(root, n=5, hw=(100, 200), num_classes=3, seed=0, jpeg_every=0):
    """n records rendered as the loader's synthetic images and saved as PNG
    (every `jpeg_every`-th as JPEG), with their COCO JSON. -> (json, records)."""
    recs = make_synthetic_records(n, hw, num_classes, seed=seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    for i, r in enumerate(recs):
        ext = "jpg" if jpeg_every and i % jpeg_every == jpeg_every - 1 else "png"
        r["file_name"] = f"img/{i}.{ext}"
        Image.fromarray(np.clip(synthetic_image(r), 0, 255).astype(np.uint8)).save(os.path.join(root, r["file_name"]))
    cats = [{"id": 10 + 3 * k, "name": f"k{k}"} for k in range(num_classes)]
    return write_coco(root, "ann.json", recs, cats), recs


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- records
def test_load_coco_json_matches_jax(tmp_path):
    """Crowd and zero-size annotations dropped, non-contiguous category ids,
    an image without annotations kept."""
    recs = make_synthetic_records(4, (60, 90), 3, seed=1)
    recs.append(dict(recs[0], image_id=99, boxes=[], classes=[]))
    cats = [{"id": 7, "name": "b"}, {"id": 2, "name": "a"}, {"id": 30, "name": "c"}]
    extra = [
        {"image_id": 1, "category_id": 7, "bbox": [1, 1, 10, 10], "iscrowd": 1},
        {"image_id": 2, "category_id": 2, "bbox": [1, 1, 0, 10], "iscrowd": 0},
        {"image_id": 3, "category_id": 30, "bbox": [1, 1, 5, -1]},
    ]
    path = write_coco(str(tmp_path), "a.json", recs, cats, extra)
    got, want = load_coco_json(path, "root"), jax_load_coco_json(path, "root")
    assert got == want
    assert got["id_map"] == {2: 0, 7: 1, 30: 2} and len(got["records"]) == 5
    assert load_coco_json(path, "root", filter_empty=True) == jax_load_coco_json(path, "root", filter_empty=True)


def test_load_voc_instances_matches_jax(tmp_path):
    base = make_voc_tree(str(tmp_path), "comic", {"train": COMIC_TRAIN})
    got = load_voc_instances(base, "train", VOC6_CLASS_NAMES)
    assert got == jax_load_voc(base, "train", VOC6_CLASS_NAMES)
    assert [r["voc_id"] for r in got["records"]] == ["c0", "c1", "c2", "c3"]
    assert got["records"][1]["difficult"] == [0, 1]
    assert load_voc_instances(base, "train", VOC6_CLASS_NAMES, True) == jax_load_voc(base, "train", VOC6_CLASS_NAMES, True)


FAMILY_NAMES = [
    "cityscapes_instancesonly_train",
    "cityscapes_instancesonly_val",
    "cityscapes_instancesonly_foggy_val_foggy_beta_0.02",
    "cityscapes_instancesonly_foggy_train_foggy_beta_0.005",
    "cityscapes_instancesonly_foggy_train_adabn",
    "cityscapes_instancesonly_foggy_val_custom_fog",
    "cityscapes_instancesonly_extra_split",
    "cityscapes_car_val",
    "sim10k_trainval",
    "sim10k_val",
    "kitti_train",
    "kitti_val",
    "clipart_traintest",
    "comic_test",
    "watercolor_val",
    "watercolor_extra_train",
]


def _entry(reg, name):
    return {k: v for k, v in reg[name].items() if k != "_cache"}


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_registry_name_families_match_jax(registries, name):
    """Each family resolves to the same paths, classes and kind as in JAX,
    through register_all_datasets or by pattern."""
    for mod in (JD, PD):
        mod.register_all_datasets()
        if name not in mod.DATASET_REGISTRY:
            mod._register_by_pattern(name)
    assert _entry(PD.DATASET_REGISTRY, name) == _entry(JD.DATASET_REGISTRY, name)
    assert set(PD.DATASET_REGISTRY) == set(JD.DATASET_REGISTRY)


def test_registry_root_precedence(monkeypatch):
    monkeypatch.delenv("SFOD_DATASETS", raising=False)
    monkeypatch.delenv("DETECTRON2_DATASETS", raising=False)
    assert PD._root() == JD._root() == "datasets"
    monkeypatch.setenv("DETECTRON2_DATASETS", "/d2")
    assert PD._root() == JD._root() == "/d2"
    monkeypatch.setenv("SFOD_DATASETS", "/sfod")
    assert PD._root() == JD._root() == "/sfod"


def test_get_dataset_loads_json_and_voc(registries):
    root = str(registries)
    os.makedirs(os.path.join(root, "cityscapes", "annotations"))
    recs = make_synthetic_records(3, (64, 128), 8, seed=2)
    cats = [{"id": k + 1, "name": n} for k, n in enumerate(PD.CITYSCAPES_THING_CLASSES)]
    write_coco(os.path.join(root, "cityscapes"), "annotations/instancesonly_filtered_gtFine_val.json", recs, cats)
    make_voc_tree(root, "comic", {"train": COMIC_TRAIN})
    for name in ("cityscapes_instancesonly_val", "comic_train"):
        got, want = PD.get_dataset(name), JD.get_dataset(name)
        for k in ("records", "thing_classes", "id_map", "image_root", "class_remap"):
            assert got[k] == want[k], (name, k)
    with pytest.raises(KeyError):
        PD.get_dataset("no_such_dataset")


def test_register_synthetic_matches_jax(registries):
    got = register_synthetic("syn", 6, (96, 160), 5, seed=3)
    want = jax_register_synthetic("syn", 6, (96, 160), 5, seed=3)
    assert got == want
    for k in ("records", "thing_classes", "id_map"):
        assert PD.get_dataset("syn")[k] == JD.get_dataset("syn")[k]


def test_divide_label_unlabel_matches_jax():
    recs = [{"image_id": i} for i in range(37)]
    for pct, seed in ((10.0, 0), (50.0, 3), (100.0, 1)):
        assert divide_label_unlabel(recs, pct, seed) == jax_divide(recs, pct, seed)


# ---------------------------------------------------------------- codec
PNG_MODES = ("RGB", "L", "P", "RGBA", "LA", "1")


@pytest.mark.parametrize("mode", PNG_MODES)
def test_png_decode_matches_pil_and_jax(tmp_path, mode):
    img = np.random.default_rng(3).integers(0, 256, (33, 41, 3), dtype=np.uint8)
    p = str(tmp_path / "m.png")
    Image.fromarray(img).convert(mode).save(p)
    with Image.open(p) as im:
        ref = np.asarray(im.convert("RGB"), np.uint8)
    got = pnc.decode(p)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jnc.decode(p))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_depth_palette_png_matches_pil(tmp_path, bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (19, 27)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 << bits).tolist())
    p = str(tmp_path / "p.png")
    im.save(p, bits=bits)
    with Image.open(p) as back:
        ref = np.asarray(back.convert("RGB"), np.uint8)
    np.testing.assert_array_equal(pnc.decode(p), ref)


@pytest.mark.parametrize("quality", [70, 90, 95])
def test_jpeg_decode_matches_pil_and_jax(tmp_path, quality):
    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    p = str(tmp_path / "q.jpg")
    Image.fromarray(img).save(p, quality=quality)
    with Image.open(p) as im:
        ref = np.asarray(im.convert("RGB"), np.uint8)
    got = pnc.decode(p)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jnc.decode(p))


def test_decode_raises_on_bad_files(tmp_path):
    """No silent fallback: unreadable, unknown and corrupt files raise. A
    16-bit PNG, refused before the codec read it, decodes as PIL's
    convert("RGB") (I;16, clipped at 255)."""
    with pytest.raises(OSError):
        pnc.decode(str(tmp_path / "missing.png"))
    (tmp_path / "x.bin").write_bytes(b"hello, not an image")
    with pytest.raises(ValueError, match=r"not a PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm \(PBM, PGM, PPM, PFM\), ICO, CUR, QOI, SGI, PCX, DCX or TGA file"):
        pnc.decode(str(tmp_path / "x.bin"))
    (tmp_path / "g.jpg").write_bytes(b"\xff\xd8\xffgarbage")
    with pytest.raises(ValueError, match="JPEG decode failed"):
        pnc.decode(str(tmp_path / "g.jpg"))
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 9).save(tmp_path / "d16.png")
    with Image.open(tmp_path / "d16.png") as im:
        np.testing.assert_array_equal(pnc.decode(str(tmp_path / "d16.png")), np.asarray(im.convert("RGB")))


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(host_libs.SOURCES, "imgcodec", (str(bad),))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_libs.build("imgcodec", build_dir=str(tmp_path / "build"))


def test_resize_random_geometries_match_pil_and_jax():
    rng = np.random.default_rng(7)
    for i in range(25):
        h, w = int(rng.integers(4, 200)), int(rng.integers(4, 200))
        if i % 2:
            nh, nw = d2_output_shape(h, w, int(rng.integers(8, 160)), 300)
        else:
            nh, nw = int(rng.integers(4, 220)), int(rng.integers(4, 220))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        got = pnc.resize_bilinear(img, nh, nw)
        np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w, nh, nw)}")
        np.testing.assert_array_equal(got, jnc.resize_bilinear(img, nh, nw))


def test_resize_cityscapes_geometry_matches_pil():
    img = np.random.default_rng(8).integers(0, 256, (1024, 2048, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((1200, 600), Image.BILINEAR))
    np.testing.assert_array_equal(pnc.resize_bilinear(img, 600, 1200), ref)


# ---------------------------------------------------------------- loader
KW = dict(canvas_hw=(64, 128), max_size=128, gt_capacity=4, prefetch=0)


def both_loaders(records, **kw):
    args = dict(KW, **kw)
    return DetectionLoader(records, **args), JaxLoader(records, **args)


def test_test_loader_file_records_with_final_padding(tmp_path):
    """PNG and JPEG files, resized from 100x200 to 60x120, 5 records in
    batches of 2 (the last padded by repeat); threaded decode and prefetch."""
    _, recs = png_dataset(str(tmp_path), n=5, jpeg_every=3)
    for r in recs:
        r["file_name"] = str(tmp_path / r["file_name"])
    got, want = both_loaders(recs, batch_size=2, min_size=60, training=False, decode_threads=3)
    got_b, want_b = list(got), list(want)
    assert len(got_b) == len(want_b) == 3
    for g, w in zip(got_b, want_b):
        assert_batches_equal(g, w)
    assert got_b[-1]["image_ids"].tolist() == [5, 5]
    p, _ = both_loaders(recs, batch_size=2, min_size=60, training=False, prefetch=2)
    for g, w in zip(p, want_b):
        assert_batches_equal(g, w)


@pytest.mark.parametrize("input_format", ["BGR", "RGB"])
def test_train_loader_multi_size_choice_from_seed(tmp_path, input_format):
    """The infinite shuffled stream with a per-image MIN_SIZE_TRAIN draw:
    the same batches for 6 steps, over an epoch boundary."""
    _, recs = png_dataset(str(tmp_path), n=5)
    for r in recs:
        r["file_name"] = str(tmp_path / r["file_name"])
    got, want = both_loaders(recs, batch_size=2, min_size=(40, 50, 60), training=True, seed=11,
                             input_format=input_format, decode_threads=2)
    gi, wi = iter(got), iter(want)
    sizes = set()
    for _ in range(6):
        g, w = next(gi), next(wi)
        assert_batches_equal(g, w)
        sizes |= {int(h) for h in g["sizes"][:, 0]}
    assert len(sizes) > 1


def test_array_and_synthetic_records():
    recs = make_synthetic_records(3, (90, 170), 4, seed=5)
    got, want = both_loaders(recs, batch_size=3, min_size=60, training=False, synthetic=True)
    assert_batches_equal(next(iter(got)), next(iter(want)))
    arr = [dict(r, image=np.clip(synthetic_image(r), 0, 255)) for r in recs]
    arr[1]["image"] = arr[1]["image"] * 1.3  # values above 255: cast as the JAX loader does
    got, want = both_loaders(arr, batch_size=3, min_size=60, training=False)
    assert_batches_equal(next(iter(got)), next(iter(want)))
    got, want = both_loaders(arr, batch_size=3, min_size=90, max_size=170, training=False)  # no resize
    assert_batches_equal(next(iter(got)), next(iter(want)))


def test_gt_overflow_and_crop():
    """More boxes than capacity (the largest kept), and a tall image whose
    single-size resize overflows the canvas (cropped, GT clipped and boxes
    outside dropped)."""
    rs = np.random.RandomState(0)
    many = {"image_id": 1, "height": 60, "width": 120, "image": rs.uniform(0, 255, (60, 120, 3)),
            "boxes": [[x, 5.0, x + 10.0 + x / 4, 40.0] for x in range(0, 90, 10)], "classes": list(range(9))}
    tall = {"image_id": 2, "height": 200, "width": 100, "image": rs.uniform(0, 255, (200, 100, 3)),
            "boxes": [[5.0, 5.0, 50.0, 50.0], [10.0, 150.0, 60.0, 190.0], [0.0, 100.0, 90.0, 160.0]],
            "classes": [0, 1, 2]}
    got, want = both_loaders([many, tall], batch_size=2, min_size=60, max_size=300, training=False)
    g, w = next(iter(got)), next(iter(want))
    assert_batches_equal(g, w)
    assert g["gt_valid"][0].all() and g["sizes"][1].tolist() == [64, 60]
    assert g["gt_valid"][1].tolist() == [True, False, True, False]


def test_multi_size_overflow_refused():
    recs = make_synthetic_records(2, (60, 120), 3)
    with pytest.raises(ValueError, match="beyond TPU.CANVAS"):
        DetectionLoader(recs, 1, (64, 128), (60, 100), 1333, training=True)


def test_abandoned_prefetch_iterator_retires_worker():
    import threading
    import time

    recs = make_synthetic_records(4, (64, 128), 3)
    before = set(threading.enumerate())
    it = iter(DetectionLoader(recs, 2, (64, 128), 64, synthetic=True, training=True, prefetch=2))
    next(it)
    it.close()
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def _cfgs(extra):
    opts = ["TPU.CANVAS", "(64, 128)", "INPUT.MIN_SIZE_TRAIN", "(40, 60)", "INPUT.MAX_SIZE_TRAIN", "128",
            "INPUT.MIN_SIZE_TEST", "60", "INPUT.MAX_SIZE_TEST", "128", "TPU.GT_CAPACITY", "4",
            "SOLVER.IMS_PER_BATCH", "2", "TEST.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "2", "SEED", "5"] + extra
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_list(opts)
        out.append(cfg)
    return out


@pytest.mark.parametrize("sup", ["100.0", "50.0"])
def test_build_loaders_from_registry(registries, sup):
    """The cfg-driven builders over a registered PNG dataset: empty images
    dropped from the train loader only, the SUP_PERCENT split."""
    root = str(registries)
    path, recs = png_dataset(root, n=6, hw=(100, 200))
    with open(path) as f:
        coco = json.load(f)
    coco["annotations"] = [a for a in coco["annotations"] if a["image_id"] != 2]  # image 2 empty
    with open(path, "w") as f:
        json.dump(coco, f)
    for mod in (PD, JD):
        mod.register_dataset("disk_set", path, root)
    pcfg, jcfg = _cfgs(["DATASETS.TRAIN", "('disk_set',)", "DATALOADER.SUP_PERCENT", sup])
    pl, jl = build_train_loader(pcfg), jax_build_train_loader(jcfg)
    assert len(pl.records) == len(jl.records) and 2 not in [r["image_id"] for r in pl.records]
    pi, ji = iter(pl), iter(jl)
    for _ in range(4):
        assert_batches_equal(next(pi), next(ji))
    pt, jt = build_test_loader(pcfg, "disk_set"), jax_build_test_loader(jcfg, "disk_set")
    assert len(pt.records) == 6
    for g, w in zip(pt, jt):
        assert_batches_equal(g, w)


# ---------------------------------------------------------------- serve resize
PREPARE_POISONED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "simple_sfod_tpu"):
    sys.modules[name] = None
import numpy as np
from simple_sfod_tpu_torch.config import get_main_cfg, detector_config_from_cfg
from simple_sfod_tpu_torch.engine.serve import DetectionService
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights
cfg = get_main_cfg()
cfg.merge_from_list(["TPU.DTYPE", "float32", "MODEL.ROI_BOX_HEAD.FC_DIM", "32"])
sd = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0).state_dict()
svc = DetectionService(cfg, sd, device="cpu")
img = np.random.RandomState(0).randint(0, 256, (1024, 2048, 3)).astype(np.uint8)
canvas, hw, scale, owh = svc._prepare(img)
svc.close()
assert sys.modules["PIL"] is None
np.savez(sys.argv[1], canvas=canvas, hw=np.asarray(hw), scale=scale, owh=np.asarray(owh))
print("prepared-ok")
"""


def test_serve_prepares_cityscapes_frame_without_pil(tmp_path):
    """With PIL poisoned, a 1024x2048 array goes through
    DetectionService._prepare to the 608x1216 canvas bit-equal to the JAX
    test loader's PIL path on the same array."""
    out = str(tmp_path / "prep.npz")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PREPARE_POISONED, out], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)
    img = np.random.RandomState(0).randint(0, 256, (1024, 2048, 3)).astype(np.uint8)
    rec = {"image_id": 1, "height": 1024, "width": 2048, "image": img, "boxes": [], "classes": []}
    want = next(iter(JaxLoader([rec], 1, (608, 1216), 600, 1333, training=False, prefetch=0)))
    assert tuple(got["hw"]) == tuple(want["sizes"][0]) == (600, 1200)
    np.testing.assert_array_equal(got["canvas"], want["images"][0])
    np.testing.assert_array_equal(got["scale"], want["scale"][0])
    assert tuple(got["owh"]) == (2048, 1024)
