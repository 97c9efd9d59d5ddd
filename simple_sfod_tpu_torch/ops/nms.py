"""Exact greedy NMS (the port of `simple_sfod_tpu/ops/nms.py:nms_mask_matrix`
and `batched_class_nms`, and of the Pallas NMS in `ops/pallas_kernels.py`).

The pipeline is the JAX package's: a stable sort by score with invalid
entries last, the score-ordered suppression relation
rel[i, j] = IoU(i, j) > thr & i < j & valid_i & valid_j, the exact greedy keep
set from that relation, and a scatter of the keep mask back to input order.

Two steps carry the work, each in two versions:

  suppress_relation_bits  the relation as a u64 row bitmask [N, ceil(N/64)]
  greedy_keep_from_bits   the keep set, in score order

On a CUDA tensor each launches its Hopper kernel (`csrc/nms.cu`, through
`_kernels.py`); on a CPU tensor each runs its plain PyTorch version
(`suppress_relation_plain` + `pack_bits`, `greedy_keep_plain`). There is no
fallback from one to the other.
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


def suppress_relation_bits(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Relation bitmask int64 [N, ceil(N/64)]: Hopper kernel 1 on CUDA, the
    plain version on the CPU."""
    if sboxes.device.type == "cpu":
        return pack_bits(suppress_relation_plain(sboxes, svalid, iou_threshold))
    return _kernels.launch_suppress_relation_bits(sboxes, svalid, iou_threshold)


def greedy_keep_from_bits(bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Keep mask [N] bool in score order: Hopper kernel 2 on CUDA (one launch,
    no host round trip), the plain fixpoint on the CPU."""
    if bits.device.type == "cpu":
        return greedy_keep_plain(unpack_bits(bits, svalid.shape[0]), svalid)
    return _kernels.launch_greedy_keep_from_bits(bits, svalid)


def score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's stable argsort of -where(valid, score, -inf): score
    descending, ties by lower index, invalid entries last."""
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    return torch.sort(-key, stable=True).indices


def nms_mask_matrix(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Exact greedy NMS. boxes [N, 4] float32, scores [N], valid [N] bool ->
    keep [N] bool in input order (a subset of `valid`)."""
    order = score_order(scores, valid)
    sboxes = boxes.to(torch.float32)[order].contiguous()
    svalid = valid[order].contiguous()
    bits = suppress_relation_bits(sboxes, svalid, iou_threshold)
    keep_sorted = greedy_keep_from_bits(bits, svalid)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep


def batched_class_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Per-class NMS by the coordinate-offset trick (detectron2 batched_nms):
    each class is shifted to its own region, so one pass never suppresses
    across classes. The shift is computed in float32 exactly as the JAX
    package does, so the IoUs round the same."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[:, None], boxes, zero).max() + 1.0
    offsets = classes.to(boxes.dtype) * max_coord
    shifted = boxes + offsets[:, None]
    return nms_mask_matrix(shifted, scores, valid, iou_threshold)
