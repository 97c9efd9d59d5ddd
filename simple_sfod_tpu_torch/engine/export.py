"""Serving artifacts: the detector's inference path exported as one file
(the port of `simple_sfod_tpu/engine/export.py`).

`torch.export` traces `models/detector.py:InferenceModule` once into an
ExportedProgram, with the weights inside it (the default) or as a call-time
argument, and with a fixed or a symbolic batch. Both NMS kernels are in the
program as the registered custom ops `sfod::suppress_relation_bits` and
`sfod::greedy_keep_from_bits` (ops/nms.py), so a process reloads and runs
it with this package's op library imported and without its model-building
code: `load_exported` imports `ops.nms` and nothing of `models`.

The calling convention is the JAX artifact's, in plain types:
    images uint8 [B, H, W, 3], sizes int32 [B, 2]
->  {"boxes": f32 [B, K, 4], "scores": f32 [B, K], "classes": i32 [B, K],
     "valid": bool [B, K]}      K = TEST.DETECTIONS_PER_IMAGE
and, for an artifact exported without its weights, the port's state dict
(Detectron2 names) as a first argument.

The file layout is the JAX package's: b"SFODX1\\n", the metadata length as
u64 little-endian, the metadata JSON (canvas, resize rule, pixel format,
class names), then the payload, here the zip archive of
`torch.export.save`.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nms  # noqa: F401  (registers the sfod:: ops a program calls)

MAGIC = b"SFODX1\n"
_ZIP = b"PK\x03\x04"
# the largest batch of a poly-batch program (CUDA's grid limits make the
# trace guard a batch of at most 65535 on some configurations)
MAX_POLY_BATCH = 1024


# buffers that hold config values (MODEL.PIXEL_MEAN/STD), not weights: the
# JAX package keeps them out of its variables, so no params_dtype rounds them
CONFIG_BUFFERS = ("pixel_mean", "pixel_std")


def cast_floating(state_dict: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Every floating weight of a state dict cast to `dtype`, parameters and
    BatchNorm statistics alike (integer tensors and CONFIG_BUFFERS
    untouched): the export-time weight cast behind params_dtype, as the JAX
    function casts every floating leaf of its variables."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return {k: v.to(dtype) if v.is_floating_point() and k not in CONFIG_BUFFERS else v for k, v in state_dict.items()}


def detection_infer_fn(detector, train_mode_bn: bool = False) -> nn.Module:
    """The detector's standard inference as an `nn.Module` returning a plain
    dict (`models/detector.py:InferenceModule`)."""
    from ..models.detector import InferenceModule

    return InferenceModule(detector.model, train_mode_bn)


class _CastAtUse(nn.Module):
    """Runs `inner` with each weight cast to the dtype it computes in: the
    program holds params_dtype weights and the convolutions and linear
    layers take them back in the dtype they were exported from (JAX
    promotes bfloat16 weights to the compute dtype; a PyTorch layer would
    raise on the mismatch)."""

    def __init__(self, inner: nn.Module, use_dtypes: Dict[str, torch.dtype]):
        super().__init__()
        self.inner = inner
        self.use_dtypes = use_dtypes

    def forward(self, images, sizes):
        state = {f"model.{k}": t.to(self.use_dtypes[k]) for k, t in _named_tensors(self.inner.model).items()}
        return torch.func.functional_call(self.inner, state, (images, sizes))


class _WeightsAsArgument(nn.Module):
    """forward(state_dict, images, sizes): `inner` run on call-time weights.
    `inner` is not a submodule, so the exported program holds none of its
    tensors."""

    def __init__(self, inner: nn.Module, use_dtypes: Dict[str, torch.dtype]):
        super().__init__()
        self.__dict__["inner"] = inner
        self.use_dtypes = use_dtypes

    def forward(self, state: Dict[str, torch.Tensor], images, sizes):
        state = {f"model.{k}": t.to(self.use_dtypes[k]) for k, t in state.items()}
        return torch.func.functional_call(self.inner, state, (images, sizes))


def _named_tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def export_inference(
    detector,
    state_dict: Dict[str, torch.Tensor],
    canvas_hw: Tuple[int, int],
    *,
    batch: Optional[int] = 1,
    bundle_params: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    train_mode_bn: bool = False,
    params_dtype: Optional[str] = None,
) -> torch.export.ExportedProgram:
    """Export the inference of `detector`'s architecture on `state_dict`
    (a port state dict) for `canvas_hw` canvases.

    batch=None leaves the batch dim symbolic: the program then takes any
    batch from 1 to MAX_POLY_BATCH. bundle_params=True puts the weights
    inside the program; bundle_params=False makes them the program's first
    argument (a plain dict with the keys, in order, and dtypes of the state
    it was exported from: `weights_argument` arranges one) and the program
    holds none.
    `device` (default CUDA) is where the program is traced and placed;
    `load_exported` can move it. params_dtype="bfloat16" stores the weights
    in bfloat16 (every floating tensor, as `cast_floating`), casts those of
    the convolutions and linear layers back at use, and normalises with
    bfloat16 statistics as flax does: it computes as the JAX artifact of the
    same params_dtype, and as `cast_detector` eagerly.
    """
    from ..models.detector import Detector
    from ..models.faster_rcnn import anchors_for

    device = resolve_device(device)
    det = Detector(detector.cfg, device=device).load_state_dict(state_dict)
    model = det.model
    # each tensor in its given dtype (a fixed bfloat16 teacher's parameters),
    # in the module's memory format
    use_dtypes = {k: t.dtype for k, t in state_dict.items()}
    _set_dtypes(model, use_dtypes)
    if params_dtype:
        use_dtypes.update(_norm_dtypes(model, params_dtype))
        _set_dtypes(model, {k: t.dtype for k, t in cast_floating(state_dict, params_dtype).items()})
    infer = detection_infer_fn(det, train_mode_bn=train_mode_bn)

    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    # an example batch of 2 for a symbolic batch: export specialises 0 and 1
    n = 2 if batch is None else int(batch)
    images = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=device)
    sizes = torch.tensor([[h, w]] * n, dtype=torch.int32, device=device)
    b = torch.export.Dim("b", min=1, max=MAX_POLY_BATCH) if batch is None else None
    dims = ({0: b}, {0: b}) if b is not None else None
    if bundle_params:
        module, args = (_CastAtUse(infer, use_dtypes) if params_dtype else infer), (images, sizes)
    else:
        state = dict(model.state_dict())  # a plain dict: callers pass one
        module, args = _WeightsAsArgument(infer, use_dtypes), (state, images, sizes)
        if dims is not None:
            dims = ({k: None for k in state},) + dims
    # the anchor grid is built before tracing, for the device the trace sees
    # (cuda:0, not cuda): one first built inside the trace would be a fake
    # tensor, left in anchors_for's cache for eager calls
    anchors_for(det.cfg, (h, w), images.device)
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=dims)
    program.example_inputs = None  # save_exported would write them into the file
    return program


def _norm_dtypes(model: nn.Module, params_dtype: str) -> Dict[str, torch.dtype]:
    """params_dtype for the floating tensors of the model's normalisation
    layers: they compute with reduced-precision statistics themselves, as
    flax does; every other layer gets its weights cast back at use."""
    from ..models.backbones.resnet import FrozenBatchNorm2d
    from ..models.backbones.vgg import BatchNorm2d

    dtype = getattr(torch, params_dtype)
    return {
        f"{name}.{k}": dtype
        for name, m in model.named_modules() if isinstance(m, (BatchNorm2d, FrozenBatchNorm2d))
        for k, t in {**m._parameters, **m._buffers}.items() if t is not None and t.is_floating_point()
    }


def cast_detector(detector, params_dtype: str):
    """A detector on `detector`'s weights as a program exported with
    params_dtype computes with them: every floating weight rounded to
    params_dtype, the normalisation layers' kept in it, the others held in
    their own dtype. The eager reference of such a program."""
    from ..models.detector import Detector

    sd = detector.model.state_dict()
    det = Detector(detector.cfg, device=detector.device).load_state_dict(cast_floating(sd, params_dtype))
    _set_dtypes(det.model, {k: t.dtype for k, t in sd.items()})
    _set_dtypes(det.model, _norm_dtypes(det.model, params_dtype))
    return det


def _set_dtypes(model: nn.Module, dtypes: Dict[str, torch.dtype]) -> None:
    """Replace each named parameter or buffer of `model` by a copy in its
    dtype of `dtypes` (memory format kept)."""
    for name, dtype in dtypes.items():
        prefix, _, leaf = name.rpartition(".")
        mod = model.get_submodule(prefix)
        if leaf in mod._parameters:
            p = mod._parameters[leaf]
            if p.dtype != dtype:
                mod._parameters[leaf] = nn.Parameter(p.detach().to(dtype), requires_grad=p.requires_grad)
        elif mod._buffers[leaf].dtype != dtype:
            mod._buffers[leaf] = mod._buffers[leaf].to(dtype)


def weights_argument(program: torch.export.ExportedProgram, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`weights` as the first argument of a program exported with
    bundle_params=False takes it: a plain dict in the exported key order
    (the program matches the dict's values to its inputs by position)."""
    spec = program.call_spec.in_spec
    child = (lambda t, i: t.child(i)) if hasattr(spec, "child") else (lambda t, i: t.children_specs[i])
    keys = list(child(child(spec, 0), 0).context)
    if set(keys) != set(weights):
        raise KeyError(f"weights differ from the exported ones in {sorted(set(keys) ^ set(weights))[:8]}")
    return {k: weights[k] for k in keys}


def save_exported(program: torch.export.ExportedProgram, path: str, meta: Optional[dict] = None) -> int:
    """Write a program (+ JSON-able serving metadata) to `path` in the
    artifact layout; returns the bytes written."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta_blob = json.dumps(meta or {}).encode()
    blob = MAGIC + struct.pack("<Q", len(meta_blob)) + meta_blob + buf.getvalue()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load_exported(
    path: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Reload an artifact -> (program, metadata), the program moved to
    `device` (default CUDA). `program.module()` runs it. Raises ValueError
    on a file that is not an artifact, and on an artifact of the JAX
    package (its payload is serialized StableHLO)."""
    from torch.export.passes import move_to_device_pass

    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path} is not a simple_sfod_tpu exported model")
    off = len(MAGIC)
    (meta_len,) = struct.unpack("<Q", blob[off : off + 8])
    off += 8
    meta = json.loads(blob[off : off + meta_len].decode())
    payload = blob[off + meta_len :]
    if not payload.startswith(_ZIP):
        raise ValueError(
            f"{path} is an artifact of the JAX package (serialized StableHLO, from jax.export); "
            "this package runs programs of torch.export: export the model with "
            "python -m simple_sfod_tpu_torch.tools.export_model"
        )
    program = torch.export.load(io.BytesIO(payload))
    return move_to_device_pass(program, resolve_device(device)), meta
