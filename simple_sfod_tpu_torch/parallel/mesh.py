"""The process layout and its collectives (the port of
`simple_sfod_tpu/parallel/mesh.py`).

In the JAX package one SPMD program sees the whole batch, and every
reduction across images is global for free. In the port each process (a
rank, one a device) sees its slice of the batch, so every such reduction
is an explicit collective here.

Layout. The world is data x model: rank r sits at data index r // model and
model index r % model, the row-major device order of the JAX mesh. A data
group holds the ranks of one model index (the gradient and the batch
statistics are summed over it); a model group holds the ranks of one data
index (the box head's tensor parallelism). A layout that does not fill the
world raises: an idle rank would be a silent waste (the JAX package's mesh
takes a prefix of the devices).

Batches. Every rank holds the same global batch (loaders with the same
seed) and takes rows [d * b, (d + 1) * b) of it (`shard_batch`), d its data
index, b the global batch over the data width: the JAX package's loader
contract (`_place`). A step's draws are drawn for the global batch and
each rank keeps its part by the layout that the draws' class declares
for every field (`shard_draws`), so a W-rank run consumes what one process
consumes.

Global-batch numerics, while `data_parallel(layout)` is entered:
  BatchNorm   train-mode statistics over the data group (`SyncBatchNorm`):
              the forward sums each rank's per-channel mean, variance and
              squared mean, the backward the two per-channel gradient sums;
  counts      the normalisers that count over the batch are summed
              (`global_sum`, `global_batch`, `batch_mean`, `global_mean`),
              so each rank's loss is its partial sum over the global count;
  gradients   one float32 buffer summed over the data group after backward
              (`all_reduce_grads`): the sum of the partial losses' gradients
              is the global loss's gradient.
Outside it every function here is the identity, and a process without a
group computes exactly as before.

Spatial sharding (TPU.SPATIAL_SHARD, a layout with `spatial`): each model
rank runs its height band of every image through the backbone
(parallel/spatial.py); the backbone's gradients are then partial sums over
the bands, summed over the model group.

Tensor parallelism (model > 1): the box head's fc1 is column-parallel and
fc2 row-parallel (`tp_dim`, the placement of the JAX package's `_tp_spec`
by the port's Detectron2 names: the JAX package's fc0/fc1 are fc1/fc2
here), joined by Megatron's f (identity forward, sum backward) and g (sum
forward, identity backward). Checkpoints and evaluation see the full
tensors (`full_box_heads`), so a file has no topology.

The backend is an argument: nccl for CUDA, gloo for the CPU (and for
several ranks on one GPU, which NCCL refuses).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

def default_backend(device) -> str:
    """nccl for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(dist_url: Optional[str], num_processes: int, process_id: int, backend: str) -> bool:
    """Join the process group (the counterpart of the JAX package's
    `initialize_distributed`). A no-op for one process without `dist_url`;
    with one, a world of 1 joins too (the collective code path on one
    device). After joining, one barrier builds the collective context while
    every rank is still in lockstep, so the first real collective does not
    wait behind one rank's slow start. `dist_url` "host:port" means
    tcp://host:port. Returns whether a group exists."""
    if dist.is_initialized():
        return True
    if num_processes <= 1 and not dist_url:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist-backend {backend!r}: nccl or gloo")
    if not dist_url:
        raise ValueError(f"{num_processes} processes need the address of rank 0 (--dist-url)")
    url = dist_url if "://" in dist_url else f"tcp://{dist_url}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    barrier()
    return True


def barrier() -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or a process without a group: the one that writes files."""
    return rank() == 0


@dataclasses.dataclass
class Layout:
    """This rank's place in a data x model world and its two groups."""

    data: int
    model: int
    rank: int
    data_group: Any
    model_group: Any  # None at model width 1
    device: torch.device  # where the collectives' own tensors live
    spatial: bool = False  # the model ranks hold height bands of each image (parallel/spatial.py)

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def data_width(world: int, data: int, model: int, batch_sizes: Sequence[int] = ()) -> int:
    """The data width of TPU.MESH_DATA / MESH_MODEL on `world` ranks: MESH_DATA
    when positive, else world // model reduced by gcd to divide every batch
    the trainer shards (the JAX BaseTrainer's auto width)."""
    if data > 0:
        return int(data)
    n = max(world // max(int(model), 1), 1)
    for b in batch_sizes:
        n = math.gcd(n, max(int(b), 1))
    return n


def make_layout(data: int, model: int) -> Optional[Layout]:
    """The layout of a data x model world (None without a process group),
    its groups made on every rank in one order. Raises unless data x model
    is the world."""
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(f"a data {data} x model {model} layout needs {data * model} processes; this one has no "
                             "process group (launch with --num-gpus or --num-machines)")
        return None
    world, me = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"the layout data {data} x model {model} = {data * model} ranks does not fill the world of "
                         f"{world} processes (TPU.MESH_DATA, TPU.MESH_MODEL and the batch sizes fix the data width)")
    if model == 1:
        data_group, model_group = dist.group.WORLD, None
    else:
        data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        data_group, model_group = data_groups[me % model], model_groups[me // model]
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    return Layout(data, model, me, data_group, model_group, device)


# -- the data-parallel context ------------------------------------------------

_ACTIVE: Optional[Layout] = None


@contextlib.contextmanager
def data_parallel(layout: Optional[Layout]) -> Iterator[None]:
    """Within: the batch of each call is this rank's slice of a global batch
    (BatchNorm and the counts reduce over the data group)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, layout
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[Layout]:
    return _ACTIVE


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """A count over this rank's images -> the count over the global batch
    (no gradient); the identity outside `data_parallel`."""
    lay = _ACTIVE
    if lay is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=lay.data_group)
    return out


def global_batch(b: int, layout: Optional[Layout] = None) -> int:
    """The global batch of which this rank holds `b` images, under `layout`
    or the active one."""
    lay = layout if layout is not None else _ACTIVE
    return b * (lay.data if lay is not None else 1)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """torch.mean over the global batch: this rank's sum over the global
    element count (equal slices)."""
    if _ACTIVE is None:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * _ACTIVE.data)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """torch.mean over the global batch, its value on every rank (no
    gradient: a normaliser, not a loss)."""
    if _ACTIVE is None:
        return torch.mean(x)
    return global_sum(torch.sum(x)) / (x.numel() * _ACTIVE.data)


class SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over `group`, NCHW, in float32 (float64
    for float64 input).
    Forward: each rank's per-channel variance, mean and squared mean are
    summed once; the global mean is their mean and the global biased
    variance mean(var_r) + mean(mean_r^2) - mean^2, which cancels only
    across the ranks' means (flax's E[x^2] - E[x]^2 cancels across every
    element). The means are plain over `width` ranks of equal counts; with
    `width` None (height bands of uneven sizes) each rank's moments are
    weighted by its element count, in float64, and the count is summed too.
    Backward: the per-channel sums of dy and dy * xhat are summed over the
    group and divided by the global count; the weight and bias gradients
    stay this rank's partial sums (the gradient all-reduce completes them).
    Returns (y in x's dtype, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group, width: Optional[int]):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays float64
        c = xf.shape[1]
        var_r, mean_r = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n = xf.numel() // c
        if width is None:
            stats = torch.cat([var_r, mean_r, mean_r * mean_r]).double() * n
            stats = torch.cat([stats, stats.new_full((1,), float(n))])
            dist.all_reduce(stats, group=group)
            count = stats[-1]  # a 0-dim tensor: no read-back
            stats = (stats[:-1] / count).to(xf.dtype)
        else:
            stats = torch.cat([var_r, mean_r, mean_r * mean_r])
            dist.all_reduce(stats, group=group)
            stats = stats / width
            count = n * width
        mean = stats[c:2 * c]
        var = stats[:c] + torch.clamp_min(stats[2 * c:] - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        y = (xf - mean.view(shape)) * (invstd * weight.to(xf.dtype)).view(shape) + bias.to(xf.dtype).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        c, shape = mean.shape[0], (1, mean.shape[0], 1, 1)
        g = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        sum_dy = g.sum(dim=(0, 2, 3))
        sum_dy_xhat = (g * xhat).sum(dim=(0, 2, 3))
        both = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(both, group=ctx.group)
        both = both / ctx.count
        gx = (g - both[:c].view(shape) - xhat * both[c:].view(shape)) * (weight.to(g.dtype) * invstd).view(shape)
        gw = sum_dy_xhat.to(weight.dtype) if ctx.needs_input_grad[1] else None
        gb = sum_dy.to(weight.dtype) if ctx.needs_input_grad[2] else None
        return gx.to(x.dtype), gw, gb, None, None, None


def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """`SyncBatchNorm` over the active layout's data group."""
    lay = _ACTIVE
    return SyncBatchNorm.apply(x, weight, bias, eps, lay.data_group, lay.data)


def all_reduce_grads(params: Sequence[torch.Tensor], layout: Layout) -> None:
    """Sum the parameters' gradients over the data group through one
    float32 buffer (a missing gradient counts as zero, as the optimizer
    takes it). With a model axis, the gradients of the tensors every model
    rank holds whole are then averaged over the model group: the ranks
    computed them from the same data, but a GPU's backward kernels may sum
    in another order in each process, and the replicas must stay bit-equal
    (the JAX package computes them once). Under height bands the backbone's
    (tagged `band_sum`, parallel/spatial.py) are each band's partial sums:
    summed over the model group, not averaged."""
    _all_reduce(params, layout.data_group)
    if layout.model > 1:
        whole = [p for p in params if getattr(p, "tp_dim", None) is None]
        _all_reduce([p for p in whole if getattr(p, "band_sum", False)], layout.model_group)
        _all_reduce([p for p in whole if not getattr(p, "band_sum", False)], layout.model_group, layout.model)


def _all_reduce(params: Sequence[torch.Tensor], group, divide: int = 1) -> None:
    """The gradients of `params` summed over `group` (then divided by
    `divide`) through one float32 buffer."""
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    if divide > 1:
        flat /= divide
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        new = flat[off:off + n].view(p.shape).to(p.dtype)
        if p.grad is None:
            p.grad = torch.empty_like(p).copy_(new)  # the parameter's memory format
        else:
            p.grad.copy_(new)
        off += n


def sum_metrics(metrics: Dict[str, torch.Tensor], lay: Optional[Layout]) -> Dict[str, torch.Tensor]:
    """Each rank's partial metrics -> the global ones (summed over the data
    group in float64); the identity without a layout."""
    if lay is None or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64).reshape(()) for k in names])
    dist.all_reduce(flat, group=lay.data_group)
    return dict(zip(names, flat.unbind()))


def any_rank(flag: bool, layout: Optional[Layout]) -> bool:
    """Whether `flag` holds on any rank (every rank gets the same answer)."""
    if layout is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=layout.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def state_hash(state) -> str:
    """sha256 of a train state's student (`state.model`) and teacher, where
    it has one: parameters and buffers in name order, as this rank holds
    them (within a trainer's `full_state()` the ranks of a tensor-parallel
    layout compare whole)."""
    import hashlib

    h = hashlib.sha256()
    teacher = getattr(state, "teacher", None)
    for module in (state.model, *([teacher] if teacher is not None else [])):
        for name, t in sorted(module.state_dict().items()):
            h.update(name.encode())
            h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def all_gather_object(obj) -> List:
    """Every rank's `obj`, in rank order, on every rank."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# -- batches --------------------------------------------------------------------

def shard_rows(layout: Optional[Layout], x, batch_size: int, blocks: int = 1):
    """This rank's rows of an array or tensor whose first dimension holds
    `blocks` blocks of `batch_size` images, one after the other, and k rows
    an image within a block, image after image: rows [d * b * k,
    (d + 1) * b * k) of each block, d the data index and b the global batch
    over the data width. Raises unless the first dimension is a multiple of
    blocks * batch_size. The identity at data width 1."""
    if x.shape[0] % (blocks * batch_size):
        raise ValueError(f"{x.shape[0]} rows are not {blocks} block(s) of {batch_size} images")
    if layout is None or layout.data == 1:
        return x
    if batch_size % layout.data:
        raise ValueError(f"the global batch of {batch_size} images does not split over the data width {layout.data}")
    b, d = batch_size // layout.data, layout.data_index
    k = x.shape[0] // (blocks * batch_size)
    parts = [blk[d * b * k:(d + 1) * b * k] for blk in (x.chunk(blocks) if blocks > 1 else (x,))]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)


def shard_batch(layout: Optional[Layout], tree: Any, batch_size: int) -> Any:
    """This rank's rows of a global batch in the loader's layout: every
    array or tensor leaf (of dicts, lists and tuples) holds one row an
    image, else this raises; other leaves pass. The identity at data width
    1."""
    if layout is None or layout.data == 1:
        return tree

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(take(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)):
            if not x.ndim or x.shape[0] != batch_size:
                raise ValueError(f"a leaf of shape {tuple(x.shape)} in a batch of {batch_size} images: one row an "
                                 "image expected")
            return shard_rows(layout, x, batch_size)
        return x

    return take(tree)


def shard_draws(layout: Optional[Layout], draws, sizes: Dict[str, Optional[int]]):
    """This rank's part of a step's draws: a NamedTuple whose class declares
    in `SHARD` how every field lays its images out. A declaration names the
    batch that the field covers, a key of `sizes` ("batch", and "target" for
    a paired trainer's target batch), as "<key>" (one block: k rows an
    image) or "<n>*<key>" (n blocks of that batch, `shard_rows`). A tuple
    field (keep masks) takes one declaration for every element, or a tuple
    of them; a NamedTuple field (StrongDraws) is split by its own `SHARD`,
    whose "batch" is the batch its parent declares; None passes. A field
    without a declaration raises, at any width: a layout is never guessed
    from a shape."""
    shard = getattr(type(draws), "SHARD", None)
    missing = [f for f in draws._fields if shard is None or f not in shard]
    if missing:
        raise TypeError(f"{type(draws).__name__} declares no layout (SHARD) for {missing}")

    def rule(decl: str):
        blocks, _, key = decl.rpartition("*")
        n = sizes.get(key)
        if n is None:
            raise ValueError(f"{type(draws).__name__}: no batch size for {decl!r} (given {sizes})")
        return n, int(blocks or 1)

    def take(x, decl):
        if x is None:
            return None
        if hasattr(x, "_fields"):
            n, blocks = rule(decl)
            if blocks != 1:
                raise ValueError(f"{type(x).__name__} in {blocks} blocks: not a layout shard_draws splits")
            return shard_draws(layout, x, {"batch": n})
        if isinstance(x, tuple):
            decls = decl if isinstance(decl, tuple) else (decl,) * len(x)
            return tuple(take(v, dv) for v, dv in zip(x, decls, strict=True))
        return shard_rows(layout, x, *rule(decl))

    return type(draws)(*(take(getattr(draws, f), shard[f]) for f in draws._fields))


# -- tensor parallelism -----------------------------------------------------------

def tp_dim(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The dimension of a state tensor that a model-axis rank holds 1/model
    of, by name (the JAX package's `_tp_spec`, on Detectron2 names and
    torch's [out, in] weights): fc1's weight and bias by rows
    (column-parallel), fc2's weight by columns (row-parallel); fc2's bias and
    every other tensor, and any dimension `model` does not divide, are held
    whole. By suffix, so the teacher's (modelTeacher.*) and the momentum's
    copies follow the parameters."""
    parts = name.split(".")
    if "box_head" not in parts:
        return None
    leaf = parts[-1]
    if "fc1" in parts:
        dim = 0
    elif "fc2" in parts and leaf == "weight":
        dim = 1
    else:
        return None
    if dim >= len(shape) or shape[dim] % model:
        return None
    return dim


def _head_tensors(head) -> List[tuple]:
    """(parameter, dim) of a box head's tensor-parallel tensors."""
    return [(head.fc1.weight, 0), (head.fc1.bias, 0), (head.fc2.weight, 1)]


def _slice(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    k = t.shape[dim] // layout.model
    return t.narrow(dim, layout.model_index * k, k).contiguous()


def _gather(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """The full tensor of every model rank's slice (exact: one slice and
    zeros summed, in float32)."""
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * layout.model
    full = torch.zeros(shape, dtype=torch.float32, device=t.device)
    full.narrow(dim, layout.model_index * k, k).copy_(t)
    dist.all_reduce(full, group=layout.model_group)
    return full.to(t.dtype)


def shard_box_head(head, layout: Optional[Layout], optimizer=None) -> None:
    """Keep this rank's slices of a full box head's fc1 and fc2 (and of
    their momentum in `optimizer`) and join them by f and g
    (models/heads.py). Raises where the placement would hold them whole (a
    head of other than two fc layers, a width the model axis does not
    divide)."""
    if layout is None or layout.model == 1:
        return
    if head.num_fc != 2:
        raise NotImplementedError(f"tensor parallelism splits a box head of 2 fc layers (this one has {head.num_fc})")
    for name, p in (("fc1.weight", head.fc1.weight), ("fc1.bias", head.fc1.bias), ("fc2.weight", head.fc2.weight)):
        if tp_dim(f"roi_heads.box_head.{name}", tuple(p.shape), layout.model) is None:
            raise ValueError(f"TPU.MESH_MODEL {layout.model} does not divide box_head.{name} {tuple(p.shape)}")
    where = {id(p): i for i, p in enumerate(optimizer.params)} if optimizer is not None else {}
    with torch.no_grad():
        for p, dim in _head_tensors(head):
            p.data = _slice(p.data, dim, layout)
            p.tp_dim = dim  # a slice: its gradient is this rank's alone
            if id(p) in where:
                optimizer.mu[where[id(p)]] = _slice(optimizer.mu[where[id(p)]], dim, layout)
    head.model_group, head.model_width = layout.model_group, layout.model


@contextlib.contextmanager
def full_box_heads(layout: Optional[Layout], heads: Sequence, optimizer=None) -> Iterator[None]:
    """Within: the sharded box heads hold their full tensors again (and the
    optimizer its full momentum), as one process holds them; afterwards each
    rank keeps its slices, bit for bit. Collective: every rank enters."""
    heads = [h for h in heads if getattr(h, "model_group", None) is not None]
    if not heads:
        yield
        return
    where = {id(p): i for i, p in enumerate(optimizer.params)} if optimizer is not None else {}
    touched = []
    with torch.no_grad():
        for head in heads:
            for p, dim in _head_tensors(head):
                p.data = _gather(p.data, dim, layout)
                if id(p) in where:
                    i = where[id(p)]
                    optimizer.mu[i] = _gather(optimizer.mu[i], dim, layout)
                touched.append((p, dim))
            head.model_group = None
    try:
        yield
    finally:
        with torch.no_grad():
            for p, dim in touched:
                p.data = _slice(p.data, dim, layout)
                if id(p) in where:
                    i = where[id(p)]
                    optimizer.mu[i] = _slice(optimizer.mu[i], dim, layout)
            for head in heads:
                head.model_group = layout.model_group


def slice_box_keep(keep, layout: Optional[Layout]):
    """The box head's dropout keep masks of this model rank: fc1's columns
    are sliced with fc1's rows; fc2's output is whole."""
    if keep is None or layout is None or layout.model == 1:
        return keep
    first = keep[0]
    k = first.shape[1] // layout.model
    return (first[:, layout.model_index * k:(layout.model_index + 1) * k], *keep[1:])


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    model group backward (in float32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.float().contiguous()
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial outputs summed over the model group forward
    (in float32), the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        out = x.float().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)
