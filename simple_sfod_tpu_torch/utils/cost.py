"""Operations and bytes of one call, and the least time an H100 could take
for it: the port's counterpart of XLA's `compiled.cost_analysis()`, which
the JAX package's `tools/roofline.py` reads.

`count(fn, *args, state=..., trained=..., optimizer_state=...)` runs `fn`
once under a `TorchDispatchMode` and returns its result with a `Cost`. The
counts come from the ATen ops that reach the dispatcher (after autograd and
autocast), forward and backward, and depend on the program alone (its ops,
shapes, dtypes and, for NMS, the data it was given), not on the device the
counter ran on, except where ATen picks a device's own op (cuDNN's batch
norm, where it is chosen, returns one more tensor). It counts:

  flops            2 x the multiply-adds of every tensor contraction:
                   `convolution` (N x the output's spatial size x the
                   weight's size; transposed, the input's spatial size),
                   `convolution_backward` the same once for each gradient
                   its output mask asks (input, weight), `mm`, `addmm`,
                   `bmm`, `baddbmm`, `mv`, `addmv` and `dot` (ROIAlign's
                   separable products, `ops/roi_align.py`, are `bmm`s).
                   The bias terms and the bias gradient are elementwise.
  elementwise_ops  one per output element of every other op that computes
                   (views, `empty` and `detach` compute nothing).
  nms_ops,         the NMS kernels (`ops/nms.py`'s `sfod::` ops), by the
  nms_bytes        rules of their bounds (`relation_bound`, `keep_bound`),
                   per image from the inputs this call gave them; kept out
                   of the two counts above and of the bytes below, since
                   neither kernel runs on the tensor cores.
  bytes_eager      each op's tensor inputs read once and outputs written
                   once, summed over the ops: what the unfused program moves.
  bytes_min        a lower bound: `state` (parameters, statistics) and the
                   call's tensor arguments read once, its tensor results
                   written once, every storage saved for backward
                   (`saved_tensors_hooks`; those of `state` and the
                   arguments excepted) written once and read once, and for
                   each tensor of `trained` its gradient written and read
                   and its new value written, and `optimizer_state` read
                   and written.

A tensor's bytes are its distinct elements (broadcast dimensions of stride
0 counted once) times its element size. Left out: the host's work, the
launches' own cost, copies the allocator or a library makes inside an op,
and every op's second read of a tensor it reads twice.

The floor is max(flops / peak flop rate, bytes_min / PEAK_BYTES_S) plus
each NMS launch's own bound; `bound_by` names the larger of the first two
terms. The flop rate is each contraction's precision's peak (bfloat16 and
float16 989e12, float32 with TF32 allowed for its kind 495e12, else
67e12), summed per precision: `Cost.peak_flops` is the rate that sum
amounts to. The peaks are NVIDIA's for one H100 SXM at its 700 W limit (the
data sheet's dense rates); a card held to a lower power limit runs below
them.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the
# flop rates of the tensor cores by precision and of float32 outside them
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12
PEAK_F32_S = 67e12
# float32 operations per (i < j, both valid) pair of the NMS relation: 2 max,
# 2 min, 2 sub, 2 clamp, 1 mul (intersection), 2 add/sub (union), 1 div,
# 1 compare; the areas are per box, not per pair
OPS_PER_PAIR = 13

aten = torch.ops.aten
_CONTRACTIONS = {
    aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
    aten.mv.default, aten.addmv.default, aten.dot.default,
    aten.convolution.default, aten.convolution_backward.default,
}
# ops that compute nothing and move no bytes (besides the views)
_NO_WORK = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default, aten.alias.default, aten._unsafe_view.default,
    aten.lift_fresh.default, aten.set_.source_Storage_storage_offset, aten.resize_.default,
}


# ---------------------------------------------------------------- the NMS kernels' bounds
def relation_bound(n: int, valid: int) -> Tuple[int, int, float, str]:
    """`suppress_relation_bits` on one image of n boxes, `valid` of them
    valid -> (bytes, operations, seconds, "bytes" or "operations"): the
    boxes (f32 x 4) and flags read once and the u64 relation rows written
    once; OPS_PER_PAIR float32 operations per pair of valid boxes."""
    words = (n + 63) // 64
    bytes_ = n * 16 + n + n * words * 8
    ops = OPS_PER_PAIR * valid * (valid - 1) // 2
    t_b, t_o = bytes_ / PEAK_BYTES_S, ops / PEAK_F32_S
    return bytes_, ops, max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def keep_bound(n: int, kept: np.ndarray) -> Tuple[int, float, str]:
    """`greedy_keep_from_bits` on one image of n boxes whose kept indices
    (in score order) are `kept` -> (bytes, seconds, "bytes"): each row's
    diagonal word, the words right of the diagonal of every kept row, valid
    in, keep out. The integer ORs are far fewer than the bytes."""
    words = (n + 63) // 64
    right = int(np.sum(words - 1 - np.asarray(kept) // 64)) if len(kept) else 0
    bytes_ = 8 * (n + right) + 2 * n
    return bytes_, bytes_ / PEAK_BYTES_S, "bytes"


def kernel1_bound_ms(sv: torch.Tensor) -> Tuple[float, str]:
    """`relation_bound` of one image's score-ordered valid flags, in ms."""
    _, _, s, by = relation_bound(sv.shape[0], int(sv.sum().item()))
    return s * 1e3, by


def kernel2_bound_ms(keep_sorted: torch.Tensor) -> Tuple[float, str]:
    """`keep_bound` of one image's score-ordered keep mask, in ms."""
    _, s, by = keep_bound(keep_sorted.shape[0], torch.nonzero(keep_sorted).flatten().cpu().numpy())
    return s * 1e3, by


# ---------------------------------------------------------------- counting
def tensor_bytes(t: torch.Tensor) -> int:
    """Distinct elements (stride-0 dimensions once) x element size."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a pytree (dataclasses and NamedTuples included)."""
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                visit(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return out


def _storage_key(t: torch.Tensor) -> Tuple[str, int]:
    return (str(t.device), t.untyped_storage().data_ptr())


def _conv_macs(out_or_grad: torch.Tensor, inp_shape, weight: torch.Tensor, transposed: bool) -> int:
    """N x spatial size x weight size: the forward convolution's
    multiply-adds (spatial: the output's, or the input's when transposed)."""
    spatial = (inp_shape if transposed else out_or_grad.shape)[2:]
    return int(out_or_grad.shape[0]) * int(np.prod(spatial, dtype=np.int64)) * weight.numel()


def _contraction_macs(func, args, out) -> Tuple[int, torch.dtype, str]:
    """(multiply-adds, operand dtype, "conv" or "matmul") of a contraction."""
    if func is aten.convolution.default:
        x, w = args[0], args[1]
        return _conv_macs(out, x.shape, w, bool(args[6])), w.dtype, "conv"
    if func is aten.convolution_backward.default:
        g, x, w, transposed, mask = args[0], args[1], args[2], bool(args[7]), args[10]
        macs = _conv_macs(g, x.shape, w, transposed)
        return macs * (int(bool(mask[0])) + int(bool(mask[1]))), w.dtype, "conv"
    if func in (aten.addmm.default, aten.baddbmm.default, aten.addmv.default):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if func in (aten.mv.default, aten.addmv.default, aten.dot.default):
        return a.numel(), a.dtype, "matmul"
    # [.., m, k] @ [.., k, n]: out has .. x m x n elements, each k products
    return out.numel() * int(a.shape[-1]), a.dtype, "matmul"


def _flop_rate(dtype: torch.dtype, kind: str) -> float:
    """The card's peak for a contraction of `kind` in `dtype`, under the
    process's TF32 settings for that kind."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_S
    if dtype == torch.float32:
        tf32 = torch.backends.cudnn.allow_tf32 if kind == "conv" else torch.backends.cuda.matmul.allow_tf32
        return PEAK_TF32_S if tf32 else PEAK_F32_S
    return PEAK_F32_S


@dataclasses.dataclass
class Cost:
    """What one call counted (module docstring); seconds are the card's
    least, from the published peaks."""

    flops: int = 0
    compute_floor_s: float = 0.0  # sum over contractions of flops / their precision's peak
    flops_by_dtype: Dict[str, int] = dataclasses.field(default_factory=dict)
    elementwise_ops: int = 0
    bytes_eager: int = 0
    bytes_min: int = 0
    nms_ops: int = 0
    nms_bytes: int = 0
    nms_seconds: float = 0.0  # the NMS launches' own bounds, summed
    nms_launches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0})
    ops: int = 0  # ATen ops that computed

    @property
    def peak_flops(self) -> float:
        """The flop rate the contractions' precisions amount to."""
        return self.flops / self.compute_floor_s if self.compute_floor_s else PEAK_BF16_S

    @property
    def bandwidth_floor_s(self) -> float:
        return self.bytes_min / PEAK_BYTES_S

    @property
    def floor_s(self) -> float:
        return max(self.compute_floor_s, self.bandwidth_floor_s) + self.nms_seconds

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_floor_s >= self.bandwidth_floor_s else "bytes"

    def scaled(self, k: int) -> "Cost":
        """The counts of 1/k of this call (one of k identical batches)."""
        return Cost(
            flops=self.flops // k, compute_floor_s=self.compute_floor_s / k,
            flops_by_dtype={d: f // k for d, f in self.flops_by_dtype.items()},
            elementwise_ops=self.elementwise_ops // k, bytes_eager=self.bytes_eager // k,
            bytes_min=self.bytes_min // k, nms_ops=self.nms_ops // k, nms_bytes=self.nms_bytes // k,
            nms_seconds=self.nms_seconds / k, nms_launches={n: c // k for n, c in self.nms_launches.items()},
            ops=self.ops // k,
        )

    def as_dict(self) -> dict:
        """The counts and the floors (ms) under the roofline tool's keys."""
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "elementwise_ops": self.elementwise_ops,
            "bytes_min": self.bytes_min,
            "bytes_eager": self.bytes_eager,
            "nms_ops": self.nms_ops,
            "nms_bytes": self.nms_bytes,
            "nms_launches": dict(self.nms_launches),
            "aten_ops": self.ops,
            "peak_flops": self.peak_flops,
            "peak_bytes_per_s": PEAK_BYTES_S,
            "machine_balance": round(self.peak_flops / PEAK_BYTES_S, 1),
            "arith_intensity_flop_per_byte": round(self.flops / max(self.bytes_min, 1), 1),
            "compute_floor_ms": self.compute_floor_s * 1e3,
            "bandwidth_floor_ms": self.bandwidth_floor_s * 1e3,
            "nms_floor_ms": self.nms_seconds * 1e3,
            "floor_ms": self.floor_s * 1e3,
            "bound_by": self.bound_by,
        }


class CostCounter(TorchDispatchMode):
    """Counts every ATen op run while it is active into `self.cost` (flops,
    elementwise operations, bytes_eager, the NMS terms); `count` adds
    bytes_min."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.cost
        if func.namespace == "sfod":
            out = func(*args, **kwargs)
            self._nms(func, args, out)
            return out
        if func not in _CONTRACTIONS:
            # an op that autograd did not take apart (inference mode) is
            # counted by the ops it is made of, as it is under autograd
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_WORK:
            return out
        c.ops += 1
        outs = _tensors(out)
        c.bytes_eager += sum(tensor_bytes(t) for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
        c.bytes_eager += sum(tensor_bytes(t) for t in outs)
        if func in _CONTRACTIONS:
            macs, dtype, kind = _contraction_macs(func, args, out[0] if isinstance(out, tuple) else out)
            name = str(dtype).replace("torch.", "")
            c.flops += 2 * macs
            c.flops_by_dtype[name] = c.flops_by_dtype.get(name, 0) + 2 * macs
            c.compute_floor_s += 2 * macs / _flop_rate(dtype, kind)
        else:
            c.elementwise_ops += sum(t.numel() for t in outs)
        return out

    def _nms(self, func, args, out) -> None:
        """One launch an image, each bounded by its kernel's rule on this
        call's data."""
        c = self.cost
        name = func.__name__.split(".")[0]
        if name == "suppress_relation_bits":
            svalid = args[1]
            n = int(svalid.shape[-1])
            for v in svalid.reshape(-1, n).sum(dim=1).tolist():
                bytes_, ops, s, _ = relation_bound(n, int(v))
                c.nms_bytes += bytes_
                c.nms_ops += ops
                c.nms_seconds += s
        elif name == "greedy_keep_from_bits":
            n = int(out.shape[-1])
            for keep in out.reshape(-1, n).cpu().numpy():
                bytes_, s, _ = keep_bound(n, np.flatnonzero(keep))
                c.nms_bytes += bytes_
                c.nms_seconds += s
        else:
            raise NotImplementedError(f"no counting rule for sfod::{name}")
        c.nms_launches[name] += int(np.prod(out.shape[:-2 if name == "suppress_relation_bits" else -1]))


def count(
    fn: Callable,
    *args,
    state: Iterable[torch.Tensor] = (),
    trained: Iterable[torch.Tensor] = (),
    optimizer_state: Iterable[torch.Tensor] = (),
    **kwargs,
):
    """Run fn(*args, **kwargs) once, counted -> (its result, Cost).
    `state` holds the tensors the call reads besides its arguments
    (parameters and statistics); `trained` the parameters a training step
    updates; `optimizer_state` the optimizer's buffers (module docstring)."""
    state, trained, optimizer_state = list(state), list(trained), list(optimizer_state)
    read = {}
    for t in state + _tensors((args, kwargs)):
        read.setdefault(_storage_key(t), tensor_bytes(t))
    saved = {}

    def pack(t):
        key = _storage_key(t)
        if key not in read:
            saved.setdefault(key, t.untyped_storage().nbytes())
        return t

    counter = CostCounter()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), counter:
        result = fn(*args, **kwargs)
    cost = counter.cost
    cost.bytes_min = (
        sum(read.values())
        + sum(tensor_bytes(t) for t in _tensors(result))
        + 2 * sum(saved.values())
        + 3 * sum(tensor_bytes(t) for t in trained)  # gradient written and read, new value written
        + 2 * sum(tensor_bytes(t) for t in optimizer_state)
    )
    return result, cost


def module_tensors(*modules: Optional[torch.nn.Module]) -> List[torch.Tensor]:
    """Every parameter and buffer of the modules (None skipped)."""
    return [t for m in modules if m is not None for t in (*m.parameters(), *m.buffers())]


def trainer_tensors(trainer) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """(state, trained, optimizer_state) of a trainer's step for `count`:
    the parameters and buffers of its models (the student, a teacher, the
    domain classifiers and heads) and its other state tensors, the
    optimizer's parameters, and its momentum buffers."""
    st = trainer.state
    modules = [st.model, getattr(st, "teacher", None)]
    for group in ("dc", "heads"):
        modules += list((getattr(st, group, None) or {}).values())
    state = module_tensors(*modules)
    thresh = getattr(st, "thresh", None)
    if thresh is not None:
        state += [thresh.reserve, thresh.classwise_acc]
    opt = st.optimizer
    return state, list(opt.params), list(opt.mu)


# ---------------------------------------------------------------- the card
def card_identity() -> Tuple[Optional[str], Optional[str]]:
    """(name, power limit) of the first card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    (None, None) where it does not run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None, None
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    if "," not in line:
        return None, None
    name, limit = line.rsplit(",", 1)
    return name.strip(), limit.strip()
