"""The port stands alone: simple_sfod_tpu_torch/ and chip_smoke.py import
nothing of JAX or of the JAX package, import yaml and PIL only inside
functions, import and serve with those modules poisoned, and refuse to run
on the CPU unless asked to."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "simple_sfod_tpu_torch")
FILES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "simple_sfod_tpu"}
LAZY = {"yaml", "PIL"}


def _imports(tree):
    """(top-level module name, inside a function?) for every absolute import."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], in_fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], in_fn))
            visit(child, fn)

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_no_jax_and_lazy_yaml_pil(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imports = _imports(tree)
    assert not [m for m, _ in imports if m in FORBIDDEN], imports
    assert not [m for m, in_fn in imports if m in LAZY and not in_fn], imports


def test_scanner_flags_module_level_imports():
    tree = ast.parse("import yaml\nfrom jax import numpy\ndef f():\n    import PIL\n")
    assert _imports(tree) == [("yaml", False), ("jax", False), ("PIL", True)]


def test_package_files_were_scanned():
    names = {os.path.relpath(p, PKG) for p in FILES}
    assert {"ops/nms.py", "ops/_kernels.py", "engine/serve.py", "models/faster_rcnn.py"} <= names
    assert {
        "host_libs.py", "data/coco.py", "data/datasets.py", "data/voc.py", "data/native_codec.py", "data/loader.py",
        "data/synthetic.py", "evaluation/coco_eval.py", "evaluation/native.py", "evaluation/f1.py",
        "evaluation/dece.py", "evaluation/voc.py", "evaluation/build.py", "engine/eval_loop.py",
    } <= names


POISONED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "simple_sfod_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import simple_sfod_tpu_torch
for m in pkgutil.walk_packages(simple_sfod_tpu_torch.__path__, "simple_sfod_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
# the serving path at canvas size needs neither yaml nor PIL
import numpy as np
from simple_sfod_tpu_torch.config import get_main_cfg, detector_config_from_cfg
from simple_sfod_tpu_torch.engine.serve import DetectionService
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights
cfg = get_main_cfg()
cfg.merge_from_list(["TPU.DTYPE", "float32", "TPU.CANVAS", "(64, 128)", "INPUT.MIN_SIZE_TEST", "64",
                     "INPUT.MAX_SIZE_TEST", "128", "MODEL.ROI_BOX_HEAD.FC_DIM", "32"])
sd = init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0).state_dict()
svc = DetectionService(cfg, sd, device="cpu")
res = svc.predict_array(np.zeros((64, 128, 3), np.uint8))
svc.close()
assert res["width"] == 128, res
for bad in ("jax", "yaml", "PIL", "simple_sfod_tpu"):
    assert sys.modules[bad] is None, bad
print("isolated-ok")
"""


def test_imports_and_serves_with_jax_yaml_pil_poisoned():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", POISONED], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated-ok" in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from simple_sfod_tpu_torch import resolve_device
    from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_main_cfg
    from simple_sfod_tpu_torch.engine.serve import DetectionService
    from simple_sfod_tpu_torch.models.detector import Detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_main_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(detector_config_from_cfg(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionService(cfg, {})
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA (here), or no repo beside the script: exit code not 0 and no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        cwd = str(tmp_path)
        shutil.copy(script, cwd)
        script = os.path.join(cwd, "chip_smoke.py")
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
