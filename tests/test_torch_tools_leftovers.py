"""The port's data tools and small leftovers against the JAX package's, on
the CPU:

  - tools/cityscapes_to_coco.py writes the JSON of the repo's
    tools/converters/cityscapes_to_coco.py, byte for byte, on a seeded
    gtFine tree (crowd groups, labels outside the 8 classes, a degenerate
    polygon), with and without --foggy-beta and --img-root;
  - tools/inspect_coco.py writes PNGs with the pixels of the JAX tool's
    (the port decodes with its own codec and writes with
    native_codec.encode_png; the JAX tool uses PIL for both);
  - data/native_codec.py:image_size gives PIL's (w, h), transposed, on PNGs
    of every colour type and on baseline JPEGs (the committed fixtures
    included);
  - utils/profiling.py: StepTimer's summary equal to the JAX StepTimer's on
    the same clock (its keys and its warm-up rule), device_trace writing a
    Chrome trace that names the op that ran; structures/image_list.py's
    ImageBatch; utils/env.py:setup_cache moving both build directories.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from simple_sfod_tpu_torch.data.native_codec import decode, encode_png, image_size
from simple_sfod_tpu_torch.tools import cityscapes_to_coco, inspect_coco

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle", "cargroup", "persongroup",
          "road", "sky"]


def jax_tool(name, subdir="tools"):
    sys.path.insert(0, os.path.join(ROOT, subdir))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def gtfine_tree(root, seed=0):
    """gtFine/<split>/<city>/<stem>_gtFine_polygons.json for 2 cities, 3
    frames each in train and 1 in val: seeded polygons of every label."""
    rs = np.random.RandomState(seed)
    for split, frames in (("train", 3), ("val", 1)):
        for city in ("aachen", "bremen"):
            d = os.path.join(root, "gtFine", split, city)
            os.makedirs(d)
            for i in range(frames):
                objects = []
                for _ in range(rs.randint(3, 12)):
                    x, y = rs.randint(0, 2000), rs.randint(0, 1000)
                    pts = [[int(x + dx), int(y + dy)] for dx, dy in rs.randint(0, 120, (rs.randint(3, 7), 2))]
                    objects.append({"label": LABELS[rs.randint(len(LABELS))], "polygon": pts})
                objects.append({"label": "car", "polygon": [[5, 5], [5, 40], [5, 80]]})  # zero width
                with open(os.path.join(d, f"{city}_{i:06d}_000019_gtFine_polygons.json"), "w") as f:
                    json.dump({"imgHeight": 1024, "imgWidth": 2048, "objects": objects}, f)
    return os.path.join(root, "gtFine")


@pytest.mark.parametrize("flags", [[], ["--foggy-beta", "0.02"], ["--img-root", "leftImg8bit", "--split", "val"]],
                         ids=["plain", "foggy", "img-root-val"])
def test_cityscapes_converter_writes_the_jax_json(tmp_path, monkeypatch, capsys, flags):
    gt_root = gtfine_tree(str(tmp_path))
    want_path, got_path = str(tmp_path / "jax" / "out.json"), str(tmp_path / "port" / "out.json")
    monkeypatch.setattr(sys, "argv", ["cityscapes_to_coco", "--gt-root", gt_root, "--output", want_path, *flags])
    jax_tool("cityscapes_to_coco", "tools/converters").main()
    want_out = capsys.readouterr().out
    out = cityscapes_to_coco.main(["--gt-root", gt_root, "--output", got_path, *flags])
    assert capsys.readouterr().out == want_out.replace(want_path, got_path)
    with open(want_path, "rb") as a, open(got_path, "rb") as b:
        assert a.read() == b.read()
    assert len(out["annotations"]) > 5 and [c["name"] for c in out["categories"]] == cityscapes_to_coco.INSTANCE_CLASSES
    assert all(a["bbox"][2] > 0 and a["bbox"][3] > 0 for a in out["annotations"])
    assert ("foggy_beta_0.02" in out["images"][0]["file_name"]) == ("--foggy-beta" in flags)


def test_inspect_coco_writes_the_jax_pixels(tmp_path, monkeypatch, capsys):
    from PIL import Image

    rs = np.random.RandomState(3)
    img_root = tmp_path / "imgs"
    img_root.mkdir()
    images, anns = [], []
    for i, (h, w, ext) in enumerate(((60, 90, "png"), (48, 64, "jpg"), (33, 47, "png"))):
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(img_root / f"f{i}.{ext}")
        images.append({"id": i + 1, "file_name": f"f{i}.{ext}", "height": h, "width": w})
        for _ in range(3):
            x, y = rs.randint(0, w - 10), rs.randint(0, h - 10)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": int(rs.randint(1, 4)),
                         "bbox": [x, y, int(rs.randint(3, 10)), int(rs.randint(3, 10))], "iscrowd": 0})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "car"},
                                              {"id": 3, "name": "bus"}]}))
    args = ["--json", str(ann), "--image-root", str(img_root), "--limit", "2"]
    monkeypatch.setattr(sys, "argv", ["inspect_coco", *args, "--out", str(tmp_path / "jax")])
    jax_tool("inspect_coco").main()
    capsys.readouterr()
    written = inspect_coco.main([*args, "--out", str(tmp_path / "port")])
    assert [os.path.basename(p) for p in written] == ["f0.png.vis.png", "f1.jpg.vis.png"]
    for p in written:
        with Image.open(p) as got, Image.open(tmp_path / "jax" / os.path.basename(p)) as want:
            assert got.mode == want.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.array_equal(decode(p), np.asarray(Image.open(p)))


def test_image_size_equals_pil(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(4)
    paths = []
    for i, mode in enumerate(("RGB", "L", "P", "RGBA", "LA", "I;16")):
        h, w = rs.randint(1, 80, 2)
        a = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
        im = Image.fromarray(a).convert(mode)
        paths.append(str(tmp_path / f"m{i}.png"))
        im.save(paths[-1])
    for i, kw in enumerate(({"quality": 80}, {"quality": 50, "subsampling": 0}, {"optimize": True}, {"quality": 95})):
        h, w = rs.randint(1, 300, 2)
        paths.append(str(tmp_path / f"j{i}.jpg"))
        Image.fromarray(rs.randint(0, 255, (h, w, 3)).astype(np.uint8)).convert("L" if i == 3 else "RGB").save(
            paths[-1], **kw)
    fixtures = os.path.join(ROOT, "tests", "torch_jpeg")
    paths += sorted(os.path.join(fixtures, f) for f in os.listdir(fixtures) if f.endswith(".jpg"))
    for p in paths:
        with Image.open(p) as im:
            assert image_size(p)[::-1] == im.size, p
    with pytest.raises(ValueError, match=r"not a PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm \(PBM, PGM, PPM, PFM\), ICO, CUR, QOI, SGI, PCX, DCX or TGA file"):
        image_size(os.path.join(fixtures, "fixtures.json"))


def test_encode_png_round_trips(tmp_path):
    from PIL import Image

    a = np.random.RandomState(5).randint(0, 256, (7, 13, 3)).astype(np.uint8)
    p = tmp_path / "a.png"
    p.write_bytes(encode_png(a))
    assert np.array_equal(decode(str(p)), a) and np.array_equal(np.asarray(Image.open(p)), a)
    with pytest.raises(ValueError, match="RGB"):
        encode_png(a[..., 0])


def test_step_timer_matches_jax(monkeypatch):
    from simple_sfod_tpu.utils import profiling as jax_profiling
    from simple_sfod_tpu_torch.utils import profiling

    clock = iter(np.cumsum([0.0, 1.5, 0.2, 0.9, 0.3, 0.4, 0.1, 0.7, 0.2, 0.5, 0.0, 0.6]).tolist() * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    summaries = []
    for mod in (jax_profiling, profiling):
        timer = mod.StepTimer(warmup=2)
        assert timer.summary()["steps"] == 0 and np.isnan(timer.summary()["median_s"])
        result = {"boxes": torch.zeros(2, 4)} if mod is profiling else {"boxes": np.zeros((2, 4))}
        durations = []
        for _ in range(6):
            timer.start()
            durations.append(timer.stop(result))
        summaries.append(timer.summary())
        assert len(timer.times) == 4 and timer.times == durations[2:]
    assert summaries[1] == summaries[0] and set(summaries[1]) == {"mean_s", "median_s", "steps"}


def test_device_trace_names_the_op(tmp_path):
    from simple_sfod_tpu_torch.ops import nms
    from simple_sfod_tpu_torch.utils.profiling import device_trace

    b = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [1.0, 1.0, 11.0, 11.0], [20.0, 20.0, 30.0, 30.0]]])
    with device_trace(str(tmp_path / "trace")):
        keep = nms.nms_mask_matrix(b, torch.tensor([[0.9, 0.8, 0.7]]), torch.ones(1, 3, dtype=torch.bool), 0.5)
    assert keep.tolist() == [[True, False, True]]
    with open(tmp_path / "trace" / "trace.json") as f:
        text = f.read()
    json.loads(text)
    assert "sfod::suppress_relation_bits" in text and "sfod::greedy_keep_from_bits" in text


def test_image_batch():
    from simple_sfod_tpu.structures.image_list import ImageBatch as JaxImageBatch
    from simple_sfod_tpu_torch.structures.image_list import ImageBatch

    b = ImageBatch(torch.zeros(3, 32, 64, 3, dtype=torch.uint8), torch.tensor([[32, 64], [30, 60], [20, 64]],
                   dtype=torch.int32), torch.ones(3))
    assert b.batch == 3 and b.canvas == (32, 64)
    assert [f.name for f in dataclasses.fields(b)] == [f.name for f in dataclasses.fields(JaxImageBatch)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.scale = torch.zeros(3)


def test_setup_cache_moves_both_build_directories(tmp_path, monkeypatch):
    from simple_sfod_tpu_torch import host_libs
    from simple_sfod_tpu_torch.ops import _kernels
    from simple_sfod_tpu_torch.utils.env import setup_cache

    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    monkeypatch.setattr(host_libs, "BUILD_DIR", host_libs.BUILD_DIR)
    env = dict(os.environ)
    cache = setup_cache(str(tmp_path / "cache"))
    assert cache == str(tmp_path / "cache") and os.path.isdir(cache)
    assert _kernels.BUILD_DIR == host_libs.BUILD_DIR == cache
    assert dict(os.environ) == env  # no environment variable of its own
    built = host_libs.build("cocoeval")
    assert os.path.dirname(built) == cache and os.path.isfile(built)
