"""Exact greedy NMS (the port of `simple_sfod_tpu/ops/nms.py:nms_mask_matrix`
and `batched_class_nms`, and of the Pallas NMS in `ops/pallas_kernels.py`).

The pipeline is the JAX package's: a stable sort by score with invalid
entries last, the score-ordered suppression relation
rel[i, j] = IoU(i, j) > thr & i < j & valid_i & valid_j, the exact greedy keep
set from that relation, and a scatter of the keep mask back to input order.
Every entry takes one image ([N]) or a batch ([B, N]); the sort, gathers
and scatter work along the last dim.

Two steps carry the work, each a registered custom op on a batch:

  sfod::suppress_relation_bits  the relation as a u64 row bitmask [B, N, ceil(N/64)]
  sfod::greedy_keep_from_bits   the keep set, in score order [B, N]

On CUDA tensors each launches its Hopper kernel (`csrc/nms.cu`, through
`_kernels.py`) once an image; on CPU tensors each runs its plain PyTorch
version (`suppress_relation_plain` + `pack_bits`, `greedy_keep_plain`). There
is no fallback from one to the other, and no other device has an
implementation. Each op's fake gives `torch.export` its shapes, so an
exported program calls the ops by name (`torch.ops.sfod.*`): it needs this
module imported to run, and nothing else of the package.
"""

from __future__ import annotations

import torch

from ..structures.boxes import pairwise_iou
from . import _kernels


def suppress_relation_plain(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Dense bool relation [N, N] of score-sorted boxes: row i may suppress
    column j. IoU as `structures/boxes.py:pairwise_iou`, compared in float32."""
    n = sboxes.shape[0]
    iou = pairwise_iou(sboxes, sboxes)
    idx = torch.arange(n, device=sboxes.device)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=sboxes.device)
    return (iou > thr) & (idx[:, None] < idx[None, :]) & svalid[:, None] & svalid[None, :]



def _bit_weights(device: torch.device) -> torch.Tensor:
    """int64 [64] with bit k set in entry k (entry 63 is the sign bit)."""
    return torch.ones(64, dtype=torch.int64, device=device) << torch.arange(64, device=device)


def pack_bits(rel: torch.Tensor) -> torch.Tensor:
    """Dense bool [N, M] -> int64 [N, ceil(M/64)]: bit j % 64 of word j // 64
    holds rel[:, j], the layout of kernel 1's uint64 words."""
    n, m = rel.shape
    words = (m + 63) // 64
    padded = torch.zeros((n, words * 64), dtype=torch.int64, device=rel.device)
    padded[:, :m] = rel.to(torch.int64)
    # the set bits of a word are distinct powers of two, so their sum is their
    # OR, and no partial sum leaves the int64 range
    return (padded.view(n, words, 64) * _bit_weights(rel.device)).sum(dim=-1)


def unpack_bits(bits: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of pack_bits: int64 [N, W] -> dense bool [N, m]."""
    n, words = bits.shape
    dense = (bits[:, :, None] & _bit_weights(bits.device)) != 0
    return dense.reshape(n, words * 64)[:, :m]


def greedy_keep_plain(rel: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """The certain-suppression fixpoint of `ops/nms.py:nms_mask_matrix`, on a
    dense relation: a box is suppressed only by a certainly kept (alive and
    unthreatened) earlier box. Equals greedy NMS exactly. -> keep [N] bool."""
    sup = torch.zeros_like(svalid)
    while True:
        alive = svalid & ~sup
        threatened = (rel & alive[:, None]).any(dim=0)
        certain = alive & ~threatened
        new_sup = sup | (rel & certain[:, None]).any(dim=0)
        if torch.equal(new_sup, sup):
            break
        sup = new_sup
    return svalid & ~sup


def _per_image(fn, out_shape, dtype, *batched: torch.Tensor) -> torch.Tensor:
    """fn on each image's slices of `batched` ([B, ...] tensors), stacked
    to [B, ...]; an empty batch gives an empty `out_shape` tensor."""
    outs = [fn(*slices) for slices in zip(*batched)]
    if not outs:
        return torch.empty(out_shape, dtype=dtype, device=batched[0].device)
    return torch.stack(outs)


def _bits_shape(svalid: torch.Tensor):
    b, n = svalid.shape
    return (b, n, (n + 63) // 64)


@torch.library.custom_op("sfod::suppress_relation_bits", mutates_args=(), device_types="cpu")
def suppress_relation_bits_op(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Relation bitmasks of a batch: sboxes float32 [B, N, 4] and svalid
    bool [B, N], each image in score order -> int64 [B, N, ceil(N/64)]. On
    the CPU, the plain version image by image."""
    return _per_image(
        lambda b, v: pack_bits(suppress_relation_plain(b, v, iou_threshold)),
        _bits_shape(svalid), torch.int64, sboxes, svalid,
    )


@suppress_relation_bits_op.register_kernel("cuda")
def _suppress_relation_bits_cuda(sboxes, svalid, iou_threshold):
    """Hopper kernel 1, one launch an image."""
    return _per_image(
        lambda b, v: _kernels.launch_suppress_relation_bits(b, v, iou_threshold),
        _bits_shape(svalid), torch.int64, sboxes.contiguous(), svalid.contiguous(),
    )


@suppress_relation_bits_op.register_fake
def _suppress_relation_bits_fake(sboxes, svalid, iou_threshold):
    return sboxes.new_empty(_bits_shape(svalid), dtype=torch.int64)


@torch.library.custom_op("sfod::greedy_keep_from_bits", mutates_args=(), device_types="cpu")
def greedy_keep_from_bits_op(bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Keep masks of a batch: bits int64 [B, N, ceil(N/64)] from
    suppress_relation_bits and svalid bool [B, N] -> keep bool [B, N] in the
    same (score) order. On the CPU, the plain fixpoint image by image."""
    n = svalid.shape[-1]
    return _per_image(
        lambda w, v: greedy_keep_plain(unpack_bits(w, n), v), tuple(svalid.shape), torch.bool, bits, svalid
    )


@greedy_keep_from_bits_op.register_kernel("cuda")
def _greedy_keep_from_bits_cuda(bits, svalid):
    """Hopper kernel 2, one launch an image, on the route N picks: the
    shared-memory kernel up to `_kernels.GREEDY_MAX_N`, its row walk above."""
    launch = (
        _kernels.launch_greedy_keep_from_bits
        if svalid.shape[-1] <= _kernels.GREEDY_MAX_N
        else _kernels.launch_greedy_keep_from_bits_rowwalk
    )
    return _per_image(launch, tuple(svalid.shape), torch.bool, bits.contiguous(), svalid.contiguous())


@greedy_keep_from_bits_op.register_fake
def _greedy_keep_from_bits_fake(bits, svalid):
    return torch.empty_like(svalid)


def _unbatched(op, *args):
    """A batched op on unbatched inputs (no leading batch dim)."""
    return op(*(a[None] if isinstance(a, torch.Tensor) else a for a in args))[0]


def suppress_relation_bits(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Relation bitmask [..., N, ceil(N/64)] of sboxes [..., N, 4] and svalid
    [..., N] (one image, or a batch): the op `sfod::suppress_relation_bits`,
    Hopper kernel 1 on CUDA, the plain version on the CPU."""
    if svalid.dim() == 1:
        return _unbatched(suppress_relation_bits_op, sboxes, svalid, iou_threshold)
    return suppress_relation_bits_op(sboxes, svalid, iou_threshold)


def greedy_keep_from_bits(bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Keep mask [..., N] bool in score order (one image, or a batch): the op
    `sfod::greedy_keep_from_bits`, Hopper kernel 2 on CUDA (one launch an
    image, no host round trip), the plain fixpoint on the CPU."""
    if svalid.dim() == 1:
        return _unbatched(greedy_keep_from_bits_op, bits, svalid)
    return greedy_keep_from_bits_op(bits, svalid)


def score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's stable argsort of -where(valid, score, -inf) along
    the last dim: score descending, ties by lower index, invalid entries
    last."""
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    return torch.sort(-key, dim=-1, stable=True).indices


def nms_mask_matrix(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Exact greedy NMS of one image or of each image of a batch. boxes
    [..., N, 4] float32, scores [..., N], valid [..., N] bool -> keep [..., N]
    bool in input order (a subset of `valid`)."""
    if valid.dim() == 1:
        return _nms_mask(boxes[None], scores[None], valid[None], iou_threshold)[0]
    return _nms_mask(boxes, scores, valid, iou_threshold)


def _nms_mask(boxes, scores, valid, iou_threshold):
    """nms_mask_matrix on [B, N] inputs: batched sort, gathers and scatter
    around the two ops."""
    order = score_order(scores, valid)
    sboxes = torch.gather(boxes.to(torch.float32), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    svalid = torch.gather(valid, 1, order).contiguous()
    bits = suppress_relation_bits_op(sboxes, svalid, iou_threshold)
    keep_sorted = greedy_keep_from_bits_op(bits, svalid)
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def batched_class_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Per-class NMS of one image or of each image of a batch ([..., N]), by
    the coordinate-offset trick (detectron2 batched_nms): each class is
    shifted to its own region, so one pass never suppresses across classes.
    The shift is each image's largest valid coordinate + 1, computed in
    float32 exactly as the JAX package does, so the IoUs round the same."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    masked = torch.where(valid[..., None], boxes, zero)
    max_coord = masked.flatten(-2).amax(dim=-1) + 1.0
    offsets = classes.to(boxes.dtype) * max_coord[..., None]
    shifted = boxes + offsets[..., None]
    return nms_mask_matrix(shifted, scores, valid, iou_threshold)
