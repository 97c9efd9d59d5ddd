"""Foreground/background subsampling with fixed shapes (the port of
`simple_sfod_tpu/ops/sampler.py`, detectron2's `subsample_labels`).

Random choice without replacement is the top-k of uniform priorities. The
priorities are an input, one per label, so a caller can hand over the JAX
package's draws (`jax.random.uniform(rng, (n,))`); the trainer draws them
from its own generator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..structures.instances import topk_indices


def subsample_labels(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    priorities: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """labels [N] int (1 positive, 0 negative, -1 ignore), priorities [N]
    float32 -> (idx [num_samples] int64, is_pos [num_samples] bool, valid
    [num_samples] bool): sampled positives first, then negatives, then
    filler. num_pos = min(#pos, num_samples * fraction), num_neg =
    min(#neg, num_samples - num_pos). Top-k ties follow `jax.lax.top_k`
    (IEEE total order, lower index first), the -inf filler included."""
    n = labels.shape[0]
    dev = labels.device
    pos_cap = min(int(num_samples * positive_fraction), n)
    neg_cap = min(num_samples, n)
    neg_inf = torch.full_like(priorities, -float("inf"))
    pos_key = torch.where(labels == 1, priorities, neg_inf)
    neg_key = torch.where(labels == 0, priorities, neg_inf)

    pos_idx = topk_indices(pos_key, pos_cap)
    pos_valid = pos_key[pos_idx] > -float("inf")
    n_pos = pos_valid.to(torch.int64).sum()

    neg_idx = topk_indices(neg_key, neg_cap)
    n_neg = num_samples - n_pos
    neg_valid = (torch.arange(neg_cap, device=dev) < n_neg) & (neg_key[neg_idx] > -float("inf"))

    all_idx = torch.cat([pos_idx, neg_idx])
    all_pos = torch.cat([torch.ones(pos_cap, dtype=torch.bool, device=dev), torch.zeros(neg_cap, dtype=torch.bool, device=dev)])
    all_valid = torch.cat([pos_valid, neg_valid])
    pad = num_samples - (pos_cap + neg_cap)
    if pad > 0:  # fewer labels than samples (small inputs only)
        all_idx = torch.cat([all_idx, torch.zeros(pad, dtype=all_idx.dtype, device=dev)])
        all_pos = torch.cat([all_pos, torch.zeros(pad, dtype=torch.bool, device=dev)])
        all_valid = torch.cat([all_valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    # compact, valid first, keeping the order (jnp.argsort(~valid, stable=True))
    order = torch.sort((~all_valid).to(torch.uint8), stable=True).indices[:num_samples]
    return all_idx[order], all_pos[order], all_valid[order]


def subsample_labels_mask(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    priorities: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask form for losses over the full anchor set: (selected [N] bool,
    selected_pos [N] bool)."""
    idx, is_pos, valid = subsample_labels(labels, num_samples, positive_fraction, priorities)
    n = labels.shape[0]
    # a scatter-max, as the JAX package's `.at[idx].max(valid)`: the filler
    # slots repeat index 0 with valid False and cannot clear a set bit
    zeros = torch.zeros(n, dtype=torch.int32, device=labels.device)
    sel = zeros.scatter_reduce(0, idx, valid.to(torch.int32), reduce="amax")
    sel_pos = zeros.scatter_reduce(0, idx, (valid & is_pos).to(torch.int32), reduce="amax")
    return sel.bool(), sel_pos.bool()
