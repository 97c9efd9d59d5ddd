"""ImageNet VGG16(-BN) initialisation in the port
(simple_sfod_tpu_torch/checkpoint/torch_import.py, its wiring into
MODEL.WEIGHTS and tools/import_weights.py) against the JAX package's
`checkpoint/torch_import.py:import_torchvision_vgg`, on the CPU.

The torchvision files are seeded state dicts with torchvision's names
(`features.{i}.*` at VGG16's full widths, a small `classifier.*`): no
download. The JAX import is spliced into a `jax.eval_shape` tree of the
detector (seeded values elsewhere) and carried by the port's
`state_dict_from_jax`; the port's import equals it key for key and bit for
bit (the layout conversions are transposes). Cases: VGG16-BN (13 convs and
13 BatchNorms; the Sim10k source YAML), VGG16 without BN (Detectron2's
shifted indices; the cityscapes `_nobn` source YAML), and the VGG-FPN
detector with and without BN (the backbone under `backbone.bottom_up.`).

Deviations from the JAX package, pinned:
  - a weights file that matches no tensor of the detector raises (the JAX
    package loads it with strict=False and trains from the init);
  - the JAX `tools/import_weights.py` writes the VGG tree over the whole
    `params["backbone"]`, which on the FPN detector drops the pyramid's
    convs; the port renames into `backbone.bottom_up.` and keeps them.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint import torch_import as jax_import
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.models import faster_rcnn as jfr
from simple_sfod_tpu_torch.checkpoint import torch_import
from simple_sfod_tpu_torch.checkpoint.checkpointer import load_torch_weights
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.tools import import_weights
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (64, 128)
SMALL = ["MODEL.ROI_BOX_HEAD.FC_DIM", "64", "TPU.CANVAS", str(CANVAS), "SOLVER.IMS_PER_BATCH", "1",
         "VIS_PERIOD", "0"]
# case -> (YAML, VGG.BN); the FPN YAML is without BN, its _bn case sets it
CASES = {
    "bn": ("faster_rcnn_VGG_sim10k_source.yaml", True),
    "nobn": ("faster_rcnn_VGG_cityscapes_foggy_source_nobn.yaml", False),
    "fpn": ("vgg16_fpn_cityscapes_to_foggy_source.yaml", False),
    "fpn_bn": ("vgg16_fpn_cityscapes_to_foggy_source.yaml", True),
}
WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def torchvision_vgg(bn: bool, seed: int = 0) -> dict:
    """A seeded state dict with torchvision vgg16(_bn)'s names and shapes
    (the classifier cut small: both importers drop it)."""
    rs = np.random.RandomState(seed)
    convs = jax_import._TV_VGG16_BN_CONVS if bn else jax_import._TV_VGG16_CONVS
    sd, c_in = {}, 3
    for idx, c in zip(convs, WIDTHS):
        sd[f"features.{idx}.weight"] = rs.normal(0, 1 / np.sqrt(9 * c_in), (c, c_in, 3, 3))
        sd[f"features.{idx}.bias"] = rs.normal(0, 0.05, c)
        if bn:
            sd[f"features.{idx + 1}.weight"] = rs.uniform(0.5, 1.5, c)
            sd[f"features.{idx + 1}.bias"] = rs.normal(0, 0.05, c)
            sd[f"features.{idx + 1}.running_mean"] = rs.normal(0, 0.1, c)
            sd[f"features.{idx + 1}.running_var"] = rs.uniform(0.5, 2.0, c)
        c_in = c
    sd["classifier.0.weight"] = rs.normal(0, 0.01, (16, 8))
    sd["classifier.0.bias"] = np.zeros(16)
    out = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    if bn:
        out.update({f"features.{i + 1}.num_batches_tracked": torch.tensor(7) for i in convs})
    return out


def seeded_tree(jdet_cfg, seed: int = 0) -> dict:
    """The JAX FasterRCNN's variables at its init's shapes (jax.eval_shape)
    with seeded values: kernels normal(0, 1/sqrt(fan_in)), biases
    normal(0, 0.05), BN scale uniform(0.5, 1.5), mean normal(0, 0.1), var
    uniform(0.5, 2)."""
    shapes = jax.eval_shape(lambda: jfr.FasterRCNN(jdet_cfg).init(
        jax.random.key(0), jnp.zeros((1, *CANVAS, 3), jnp.float32)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rs.normal(0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        if name == "mean":
            return rs.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 2.0 if name == "var" else 1.5, leaf.shape).astype(np.float32)
        return rs.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def cfg_pair(case, *opts, tmp_path=None):
    yaml, bn = CASES[case]
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_file(os.path.join(ROOT, "configs", yaml), allow_new=True)
        c.merge_from_list(SMALL + ["VGG.BN", str(bn)] + list(opts))
        if tmp_path is not None:
            c.OUTPUT_DIR = str(tmp_path)
        out.append(c)
    return out


def jax_import_via_from_jax(tv: dict, jcfg, pcfg) -> dict:
    """The JAX import spliced into the detector's tree where its backbone
    lives (`bottom_up` under FPN), carried by state_dict_from_jax; the
    backbone's keys."""
    params, stats = jax_import.import_torchvision_vgg({k: v.numpy() for k, v in tv.items()}, bn=pcfg.vgg_bn)
    variables = seeded_tree(jax_lower(jcfg))
    for col, tree in (("params", params), ("batch_stats", stats)):
        if col not in variables:
            continue
        backbone = dict(variables[col]["backbone"])
        if pcfg.fpn:
            backbone["bottom_up"] = tree
        else:
            backbone = tree
        variables[col] = {**variables[col], "backbone": backbone}
    prefix = "backbone.bottom_up." if pcfg.fpn else "backbone."
    return {k: v for k, v in state_dict_from_jax(variables, pcfg).items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(CASES))
def test_import_equals_the_jax_import_key_for_key(case):
    pc, jc = cfg_pair(case)
    pcfg = detector_config_from_cfg(pc)
    assert pcfg.vgg_bn == CASES[case][1] and pcfg.fpn == case.startswith("fpn")
    tv = torchvision_vgg(pcfg.vgg_bn)
    got = torch_import.import_torchvision_vgg(tv, pcfg.vgg_bn, pcfg.fpn)
    want = jax_import_via_from_jax(tv, jc, pcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    convs = [k for k in got if k.endswith(".weight") and got[k].dim() == 4]
    bns = [k for k in got if k.endswith(".running_var")]
    assert len(convs) == 13 and len(bns) == (13 if pcfg.vgg_bn else 0)
    assert not any("classifier" in k for k in got)


@pytest.mark.parametrize("case", list(CASES))
def test_model_weights_loads_every_backbone_tensor(tmp_path, capsys, case):
    """The torchvision file as MODEL.WEIGHTS of the config's trainer: every
    backbone tensor is the file's (0 kept their initialisation), the heads
    and the pyramid keep theirs."""
    pc, _ = cfg_pair(case, tmp_path=tmp_path)
    tv = torchvision_vgg(CASES[case][1], seed=1)
    path = str(tmp_path / "vgg16_imagenet.pth")
    torch.save(tv, path)
    pc.MODEL.WEIGHTS = path
    tr = build_trainer(pc, device="cpu")
    init = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    tr.resume_or_load()
    assert "(0 of the backbone's)" in capsys.readouterr().out
    want = torch_import.import_torchvision_vgg(tv, tr.det_cfg.vgg_bn, tr.det_cfg.fpn)
    got = tr.state.model.state_dict()
    backbone = [k for k in got if k.startswith("backbone.") and not k.startswith("backbone.fpn_")]
    assert sorted(backbone) == sorted(want)
    for k in backbone:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    rest = [k for k in got if k not in want]
    assert rest and all(torch.equal(got[k], init[k]) for k in rest)
    assert any(k.startswith("backbone.fpn_") for k in rest) == tr.det_cfg.fpn


@pytest.mark.parametrize("file_bn", [True, False])
def test_a_bn_layout_mismatch_raises_naming_both(tmp_path, file_bn):
    yaml = CASES["nobn" if file_bn else "bn"][0]
    pc = get_cfg()
    pc.merge_from_file(os.path.join(ROOT, "configs", yaml))
    pc.merge_from_list(SMALL)
    path = str(tmp_path / "vgg.pth")
    torch.save(torchvision_vgg(file_bn), path)
    with pytest.raises(ValueError, match=r"vgg16(_bn)? \(conv indices .* VGG16 with(out)? BatchNorm"):
        load_torch_weights(path, detector_config_from_cfg(pc))


@pytest.mark.parametrize("yaml", ["faster_rcnn_VGG_sim10k_source_nobn.yaml", "faster_rcnn_VGG_kitti_source_nobn.yaml"])
def test_car_nobn_yamls_build_vgg16_bn_in_both_packages(yaml):
    """The Sim10k and KITTI `_nobn` source YAMLs do not set VGG.BN, so in
    both packages they build VGG16-BN and take vgg16_bn.pth (the
    cityscapes `_nobn` YAMLs set VGG.BN False)."""
    pc, jc = get_cfg(), jax_get_cfg()
    for c in (pc, jc):
        c.merge_from_file(os.path.join(ROOT, "configs", yaml))
    assert detector_config_from_cfg(pc).vgg_bn and jax_lower(jc).vgg_bn


@pytest.mark.parametrize("content", ["adain_encoder", "resnet_imagenet", "empty"])
def test_a_file_that_matches_no_parameter_raises(tmp_path, content):
    """A deliberate deviation: the JAX package overlays such a file with
    strict=False and trains from the initialisation without a word."""
    pc, _ = cfg_pair("bn", tmp_path=tmp_path)
    files = {
        "adain_encoder": {"0.weight": torch.zeros(3, 3, 1, 1), "2.weight": torch.zeros(64, 3, 3, 3)},
        "resnet_imagenet": {"conv1.weight": torch.zeros(64, 3, 7, 7), "fc.weight": torch.zeros(1000, 2048)},
        "empty": {},
    }
    path = str(tmp_path / "w.pth")
    torch.save(files[content], path)
    pc.MODEL.WEIGHTS = path
    tr = build_trainer(pc, device="cpu")
    with pytest.raises(ValueError, match="match no parameter"):
        tr.resume_or_load()


def test_torchvision_file_for_a_resnet_detector_raises(tmp_path):
    pc = get_cfg()
    pc.merge_from_file(os.path.join(ROOT, "configs", "r_101_c4_cs_source.yaml"))
    path = str(tmp_path / "vgg.pth")
    torch.save(torchvision_vgg(True), path)
    with pytest.raises(ValueError, match="VGG16 backbone only"):
        load_torch_weights(path, detector_config_from_cfg(pc))


@pytest.mark.parametrize("case", ["bn", "fpn"])
def test_import_tool_writes_a_file_both_packages_read(tmp_path, case):
    """tools/import_weights.py --kind torchvision_vgg: the config's seeded
    detector with the file's backbone; MODEL.WEIGHTS of the port takes all
    of it, and the JAX package's load_torch_file + import_torch_checkpoint
    reads the backbone as its own import_torchvision_vgg (single-level: the
    JAX importer has no FPN naming). Then --kind detector on that output
    gives it back unchanged."""
    yaml, bn = CASES[case]
    tv = torchvision_vgg(bn, seed=2)
    src, out = str(tmp_path / "vgg16.pth"), str(tmp_path / "init.pth")
    torch.save(tv, src)
    opts = SMALL + ["VGG.BN", str(bn)]
    import_weights.main(["--torch", src, "--kind", "torchvision_vgg", "--config-file",
                         os.path.join(ROOT, "configs", yaml), "--output", out, *opts])
    pc, jc = cfg_pair(case, tmp_path=tmp_path)
    pcfg = detector_config_from_cfg(pc)
    written = torch.load(out, weights_only=True)["model"]
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN

    FasterRCNN(pcfg).load_state_dict(written, strict=True)
    want = torch_import.import_torchvision_vgg(tv, bn, pcfg.fpn)
    assert all(torch.equal(written[k], want[k]) for k in want if not k.endswith("num_batches_tracked"))
    if not pcfg.fpn:
        params, stats = jax_import.import_torch_checkpoint(jax_import.load_torch_file(out), jax_lower(jc))
        jp, js = jax_import.import_torchvision_vgg({k: v.numpy() for k, v in tv.items()}, bn=bn)
        for got, ref in ((params["backbone"], jp), (stats["backbone"], js)):
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
            assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)))
    again = str(tmp_path / "again.pth")
    import_weights.main(["--torch", out, "--kind", "detector", "--config-file", os.path.join(ROOT, "configs", yaml),
                         "--output", again, *opts])
    back = torch.load(again, weights_only=True)["model"]
    assert sorted(back) == sorted(written) and all(torch.equal(back[k], written[k]) for k in written)
    del written["roi_heads.box_predictor.bbox_pred.weight"]
    torch.save({"model": written}, again)
    with pytest.raises(ValueError, match="bbox_pred.weight"):
        import_weights.main(["--torch", again, "--kind", "detector", "--config-file",
                             os.path.join(ROOT, "configs", yaml), "--output", str(tmp_path / "x.pth"), *opts])


def test_jax_import_tool_drops_the_pyramid_on_an_fpn_detector(tmp_path, monkeypatch):
    """A fault of the reference, pinned: the JAX tools/import_weights.py
    (run as a script, its init and orbax save stubbed) writes the VGG tree
    over params["backbone"] of the FPN detector, so the saved tree has no
    bottom_up and no fpn_lateral/fpn_output convs. The port's tool keeps
    them (test above)."""
    from simple_sfod_tpu.checkpoint import checkpointer as jax_checkpointer
    from simple_sfod_tpu.models import detector as jax_detector

    saved = {}

    class Capture:
        def __init__(self, directory, *a, **k):
            pass

        def save(self, name, tree, *a, **k):
            saved[name] = tree

    monkeypatch.setattr(jax_checkpointer, "Checkpointer", Capture)
    monkeypatch.setattr(jax_detector.Detector, "init", lambda self, rng, canvas_hw, batch=1: seeded_tree(self.cfg))
    src = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_vgg(False), src)
    monkeypatch.setattr(sys, "argv", ["import_weights.py", "--torch", src, "--kind", "torchvision_vgg",
                                      "--config-file", os.path.join(ROOT, "configs", CASES["fpn"][0]),
                                      "--output", str(tmp_path / "jax_init")])
    runpy.run_path(os.path.join(ROOT, "tools", "import_weights.py"), run_name="__main__")
    backbone = saved["jax_init"]["params"]["backbone"]
    assert sorted(backbone) == sorted(f"conv{i}" for i in range(13))
    assert "bottom_up" not in backbone and not any(k.startswith("fpn_") for k in backbone)
