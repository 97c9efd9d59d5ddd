"""The port stands alone: simple_sfod_tpu_torch/ and chip_smoke.py import
nothing of JAX or of the JAX package, import yaml and PIL only inside
functions, import, read the main YAML and serve with those modules
poisoned, and refuse to run on the CPU unless asked to. A process that runs
NMS starts without torch._dynamo, and the standard-library tool without
torch."""

import ast
import os
import re
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
# `tools` is the repo's JAX-side tools/ directory (the port's tools are
# relative imports of simple_sfod_tpu_torch/tools/); the port decodes TIFF's
# LZMA and ZSTD with its own C++ (data/csrc/xz.cpp, zstd.cpp), not Python's
# lzma, zstandard, zstd or Python 3.14's compression.zstd, which the card's
# machine may lack
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "simple_sfod_tpu", "tools", "lzma", "zstandard", "zstd",
             "compression"}
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


def test_pil_only_inside_draw_detections():
    """PIL is imported by utils/visualize.py:draw_detections and nowhere
    else: the GPU machine has no PIL, and the metrics toolkit and GUI read
    image sizes from the file headers (data/native_codec.py:image_size)."""
    users = {}
    for path in FILES:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for m, _ in _imports(ast.Module(body=node.body, type_ignores=[])):
                    if m == "PIL":
                        users.setdefault(os.path.relpath(path, ROOT), set()).add(node.name)
    assert users == {"simple_sfod_tpu_torch/utils/visualize.py": {"draw_detections"}}, users


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
    assert {
        "config/yaml_subset.py", "engine/events.py", "engine/hooks.py", "utils/visualize.py",
        "checkpoint/checkpointer.py", "tools/train_net.py", "tools/train_net_mt.py",
    } <= names
    assert "models/backbones/resnet.py" in names
    assert {"tools/sim10k_to_coco.py", "tools/kitti_to_coco.py"} <= names
    assert {"engine/export.py", "tools/export_model.py", "tools/serve_model.py", "utils/bench.py"} <= names
    assert {"models/dann.py", "engine/trainers/da.py", "engine/trainers/adaptive_teacher.py"} <= names
    assert {
        "evaluation/gui.py", "evaluation/toolkit.py", "evaluation/runner.py", "evaluation/report.py",
        "evaluation/tube.py", "checkpoint/torch_export.py", "structures/image_list.py", "utils/profiling.py",
        "utils/env.py", "tools/metrics_tool.py", "tools/metrics_gui.py", "tools/export_weights.py",
        "tools/cityscapes_to_coco.py", "tools/inspect_coco.py",
    } <= names
    assert {"utils/cost.py", "tools/roofline.py", "tools/profile_step.py"} <= names


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has one of the same relative path in
    the port, except ops/pallas_kernels.py, whose two kernels are the port's
    ops/csrc/nms.cu (ops/nms.py registers them)."""
    jax_pkg = os.path.join(ROOT, "simple_sfod_tpu")
    jax_modules = {os.path.relpath(os.path.join(d, f), jax_pkg) for d, _, fs in os.walk(jax_pkg) for f in fs
                   if f.endswith(".py")}
    names = {os.path.relpath(p, PKG) for p in FILES}
    assert jax_modules - names == {"ops/pallas_kernels.py"}
    assert os.path.isfile(os.path.join(PKG, "ops", "csrc", "nms.cu"))


# the repo's tools/*.py without a counterpart of the same name in
# simple_sfod_tpu_torch/tools/, each with its reason
TOOLS_NOT_PORTED = {
    "bench_extra": "queued for the port's benchmark (inference at batch 1, the SFAT step at batch 4)",
    "bench_fpn": "queued for the port's benchmark (the FPN supervised step)",
    "bench_serving": "queued for the port's benchmark (the exported artifact reloaded and called)",
    "bench_pallas_nms": "chip_smoke.py's timing phase times both NMS kernels against their bounds",
    "ab_stats": "a measurement of the JAX package against the reference, not of the workload",
    "endpoint_ab": "a measurement of the JAX package against the reference, not of the workload",
    "endpoint_ab_sfat": "a measurement of the JAX package against the reference, not of the workload",
    "lockstep_diff": "a measurement of the JAX package against the reference, not of the workload",
    "measure_roi_cap": "a measurement of the JAX package's own cap, not of the workload",
    "measure_rpn_caps": "a measurement of the JAX package's own caps, not of the workload",
    "quantify_mosaic_padding": "a measurement of the JAX package's mosaic padding, not of the workload",
    "diag_mosaic_padded": "a diagnosis of the JAX package's mosaic padding, not of the workload",
}


def test_every_jax_tool_has_a_counterpart_or_a_reason():
    """Every tools/*.py of the repo has a counterpart in the port's tools/,
    or stands in TOOLS_NOT_PORTED with its reason; a tool that is ported
    leaves the list."""
    jax_tools = {f[:-3] for f in os.listdir(os.path.join(ROOT, "tools")) if f.endswith(".py")}
    port_tools = {f[:-3] for f in os.listdir(os.path.join(PKG, "tools")) if f.endswith(".py")}
    assert jax_tools - port_tools == set(TOOLS_NOT_PORTED)
    assert {"roofline", "profile_step"} <= port_tools and all(TOOLS_NOT_PORTED.values())


def _build_sources():
    from simple_sfod_tpu_torch import host_libs
    from simple_sfod_tpu_torch.ops import _kernels

    return {**{f"host_libs:{k}:{os.path.basename(v)}": v for k, vs in host_libs.SOURCES.items() for v in vs},
            **{f"_kernels:{k}": v for k, v in _kernels.SOURCES.items()}}


def test_build_sources_lie_inside_the_package():
    """Every C++ and CUDA source that the port compiles (the host libraries
    of host_libs.py, the kernel libraries of ops/_kernels.py) is a file of
    the package itself, not of the repo around it."""
    sources = _build_sources()
    assert {"host_libs:imgcodec:imgcodec.cpp", "host_libs:imgcodec:jpeg_decode.cpp", "host_libs:imgcodec:webp_vp8.cpp",
            "host_libs:imgcodec:webp_vp8l.cpp", "host_libs:cocoeval:cocoeval.cpp", "_kernels:nms"} <= set(sources)
    outside = {k: p for k, p in sources.items()
               if os.path.commonpath([os.path.realpath(p), os.path.realpath(PKG)]) != os.path.realpath(PKG)}
    assert not outside, outside
    assert all(os.path.isfile(p) and p.endswith((".cpp", ".cu")) for p in sources.values()), sources


def test_no_system_image_library():
    """The codec builds from the port's sources alone: no port source
    includes libjpeg's, libpng's, libwebp's or libtiff's headers, links
    -ljpeg, -lwebp or -ltiff, or calls nvjpeg, and the g++ command line of
    the host libraries names nothing else."""
    from simple_sfod_tpu_torch import host_libs

    texts = {}
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if f.endswith((".py", ".cpp", ".cu", ".h", ".cuh")):
                with open(os.path.join(d, f)) as fh:
                    texts[os.path.relpath(os.path.join(d, f), ROOT)] = fh.read()
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        texts["chip_smoke.py"] = fh.read()
    for needle in ("jpeglib.h", "png.h", "-ljpeg", "nvjpeg", "-lwebp", "libwebp.so", "tiffio.h", "-ltiff",
                   "libtiff.so"):
        assert not [p for p, t in texts.items() if needle in t], needle
    include = re.compile(r"#\s*include\s*[<\"](webp|png|jpeg|turbojpeg|tiff)")
    assert not [p for p, t in texts.items() if include.search(t)]
    for p in host_libs.SOURCES["imgcodec"]:
        with open(p) as fh:
            assert set(re.findall(r"#\s*include\s*<([^>]+)>", fh.read())) <= SYSTEM_HEADERS, p
    assert not [f for f in host_libs.CXX_FLAGS if f.startswith(("-l", "-D"))], host_libs.CXX_FLAGS
    assert {"jpeg_decode.cpp", "webp_vp8.cpp", "webp_vp8l.cpp", "ccitt.cpp"} <= {
        os.path.basename(p) for p in host_libs.SOURCES["imgcodec"]}


def test_tiff_decoders_are_the_ports_own():
    """TIFF's codecs (LZW, PackBits, CCITT, JPEG through the port's JPEG
    decoder) are sources of the imgcodec library: none includes a TIFF,
    JPEG or zlib header of the system, and native_codec.py reaches no
    other decoder (no PIL, tifffile, imagecodecs or ctypes.util lookup)."""
    from simple_sfod_tpu_torch import host_libs

    names = {os.path.basename(p) for p in host_libs.SOURCES["imgcodec"]}
    assert {"containers.cpp", "ccitt.cpp", "jpeg_decode.cpp"} <= names
    for p in host_libs.SOURCES["imgcodec"]:
        with open(p) as fh:
            headers = set(re.findall(r"#\s*include\s*[<\"]([^>\"]+)[>\"]", fh.read()))
        assert not {h for h in headers if re.match(r"(tiff|tiffio|tiffconf|jpeglib|zlib)\.h$", h)}, (p, headers)
        assert headers <= SYSTEM_HEADERS, (p, headers)
    with open(os.path.join(PKG, "data", "native_codec.py")) as fh:
        text = fh.read()
    for needle in ("import PIL", "from PIL", "tifffile", "imagecodecs", "ctypes.util", "find_library"):
        assert needle not in text, needle


# the C++ standard library headers the codec's sources include
SYSTEM_HEADERS = {"algorithm", "cmath", "cstddef", "cstdint", "cstdlib", "cstring", "new", "vector", "array",
                  "cstdio", "limits", "memory", "utility", "functional", "numeric", "climits", "string"}


def test_codec_build_line_names_no_library(tmp_path, monkeypatch):
    """host_libs.build runs g++ with CXX_FLAGS, the output and the sources
    of the codec and nothing else: no -l, -L or -I."""
    from simple_sfod_tpu_torch import host_libs

    argvs = []

    def fake_run(argv, **kw):
        argvs.append(list(argv))
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(host_libs.subprocess, "run", fake_run)
    host_libs.build("imgcodec", build_dir=str(tmp_path))
    (argv,) = argvs
    srcs = list(host_libs.SOURCES["imgcodec"])
    assert argv[1:1 + len(host_libs.CXX_FLAGS)] == list(host_libs.CXX_FLAGS)
    assert argv[1 + len(host_libs.CXX_FLAGS)] == "-o" and argv[-len(srcs):] == srcs
    assert len(argv) == 3 + len(host_libs.CXX_FLAGS) + len(srcs)
    assert not [a for a in argv if a.startswith(("-l", "-L", "-I"))]


POISONED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "simple_sfod_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import simple_sfod_tpu_torch
for m in pkgutil.walk_packages(simple_sfod_tpu_torch.__path__, "simple_sfod_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
# the main YAML reads without yaml, and the serving path at canvas size
# needs neither yaml nor PIL
import numpy as np
from simple_sfod_tpu_torch.config import get_cfg, get_main_cfg, detector_config_from_cfg
main_yaml = get_cfg()
main_yaml.merge_from_file("configs/faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml")
assert main_yaml == get_main_cfg(), "main YAML"
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
    from simple_sfod_tpu_torch.parallel.dryrun import dryrun_multigpu

    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multigpu(2)
    from simple_sfod_tpu_torch.tools import profile_step, roofline

    for argv in ([], ["--headline"], ["--eval", "--stages"], ["--serving", "--artifact", "x.sfodx"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            roofline.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_step.main(["--steps", "1"])
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


# What a fresh process must not import: torch._dynamo costs seconds of start-up
# (6.9 s on an H100 host) and NMS has no need of it; the standard-library tool
# needs no torch at all.
STARTUP = {
    "nms_ops_without_dynamo": (
        "import sys, torch\n"
        "from simple_sfod_tpu_torch.ops import nms\n"
        "b = torch.tensor([[[0., 0., 10., 10.], [1., 1., 11., 11.], [20., 20., 30., 30.]]], requires_grad=True)\n"
        "keep = nms.nms_mask_matrix(b, torch.tensor([[0.9, 0.8, 0.7]]), torch.ones(1, 3, dtype=torch.bool), 0.5)\n"
        "assert keep.tolist() == [[True, False, True]], keep\n",
        "torch._dynamo",
    ),
    "prediction_to_gt_without_torch": ("import simple_sfod_tpu_torch.tools.prediction_to_gt\n", "torch"),
}


@pytest.mark.parametrize("case", list(STARTUP))
def test_startup_imports(case):
    code, absent = STARTUP[case]
    code += f"assert {absent!r} not in sys.modules, {absent!r}\nprint('startup-ok')\n"
    out = subprocess.run([sys.executable, "-c", "import sys\n" + code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0 and "startup-ok" in out.stdout, out.stderr[-3000:]
