"""k-hop neighbor sampler (GraphSAGE-style, static shapes), the JAX
package's ``graph/sampler.py`` on one device.

Occurrence-tree formulation: every sampled neighbor is a fresh
"occurrence node"; layer l has B*f1*...*fl occurrences.  Edges connect
child occurrences to their parent occurrence, giving a forest the GNN
aggregates bottom-up.  Zero-degree vertices self-sample (self-loop).

The draws come from an explicit ``torch.Generator`` (on the device of
``row_ptr``), where the JAX package draws ``jax.random.randint`` bits:
the tree's layout is the JAX package's exactly, and each child is a
uniform pick from its parent's CSR row, by the same ``r % deg`` rule.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def khop_sample(gen: torch.Generator, row_ptr: torch.Tensor,
                col_idx: torch.Tensor, seeds: torch.Tensor,
                fanouts: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Returns occurrence-tree tensors: node_ids (n_sub,),
    senders/receivers (E_sub,), edge_mask (E_sub,), and n_seed (an int).
    Occurrences 0..B-1 are the seeds (the loss is taken on them)."""
    dev = row_ptr.device
    layers = [seeds.to(torch.int32)]
    offsets = [0]
    senders, receivers = [], []
    total = seeds.shape[0]
    last = max(col_idx.numel() - 1, 0)
    for f in fanouts:
        parents = layers[-1].long()                # (P,) vertex ids
        P = parents.shape[0]
        start = row_ptr[parents].long()
        deg = (row_ptr[parents + 1].long() - start)
        r = torch.randint(0, 1 << 30, (P, f), generator=gen, device=dev)
        eidx = start[:, None] + r % deg.clamp(min=1)[:, None]
        # an isolated parent's eidx may point one past the array: the JAX
        # gather clamps it, and the value is discarded either way
        eidx = eidx.clamp_(max=last)
        child = (torch.where(deg[:, None] > 0, col_idx[eidx].long(),
                             parents[:, None]) if col_idx.numel()
                 else parents[:, None].expand(P, f))
        child = child.reshape(-1).to(torch.int32)
        parent_occ = offsets[-1] + torch.arange(P, dtype=torch.int32,
                                                device=dev)
        child_occ = total + torch.arange(P * f, dtype=torch.int32,
                                         device=dev)
        senders.append(child_occ)
        receivers.append(parent_occ.repeat_interleave(f))
        offsets.append(total)
        layers.append(child)
        total += P * f
    n_edges = sum(x.shape[0] for x in layers[1:])
    return {
        "node_ids": torch.cat(layers),
        "senders": torch.cat(senders),
        "receivers": torch.cat(receivers),
        "edge_mask": torch.ones(n_edges, dtype=torch.float32, device=dev),
        "n_seed": int(seeds.shape[0]),
    }
