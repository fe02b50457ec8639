"""Hill-climb cells beyond the baseline: GNN aggregation through the
paper's 2D expand/fold partition (``core/spmm.py``'s schedule) on the
simulated mesh, the JAX package's ``launch/optimized.py``.

gin-tu-2d trains GIN with each layer's aggregation as a 2D SpMM: the
features expand (a permute to layout B and a tiled all-gather along
"data" give each block its column strip X[C_j]), each block sums its
edges into its row strip, and a combining reduce-scatter along "model"
folds the strips back to layout A.  mace-2d does the same for MACE: the
positions and the scalar channel expand, the (nr, C, 9) first-order
features fold, the Gaunt products stay chunk-local.

The JAX cells pad every block to ``cap`` edges and multiply the padding
by a mask.  The port sums each block's ``nnz`` live edges alone, as
``spmm_2d`` does: on one card the padding of all blocks is held at
once, and R-MAT's heaviest block sets a capacity several times the
mean.  On ``meta`` the live edges cannot be counted (that is a host
read), so a trace there takes every slot: the static bound.

``block_edges`` and ``node_blocks`` lay a concrete graph and its node
data out on the grid (no deduplication: the blocks hold the same edge
multiset as the edge list), for the card and the tests.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_config
from repro_torch.core import collectives
from repro_torch.core.collectives import COL, GRID_2D
from repro_torch.core.partition import Partition2D, make_partition
from repro_torch.launch.cells import Cell, _round_up, _t, _train_step
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import mace as mace_mod
from repro_torch.optim.adamw import AdamW, AdamWState

GRID = ("data", "model")


def _part_and_cap(shape, mesh) -> Tuple[Partition2D, int]:
    pr, pc = mesh.shape["data"], mesh.shape["model"]
    part = make_partition(shape.n_nodes, pr, pc, align=128)
    return part, _round_up(int(shape.n_edges / part.p * 1.4), 128)


def block_edges(part: Partition2D, senders: torch.Tensor,
                receivers: torch.Tensor, cap: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(esrc, ridx, (pr, pc, cap) int32; nnz, (pr, pc) int32): edge u -> v
    in block (v // nr, u // nc) at its local column and row, in the
    edge list's order; the slots past nnz are 0.  ``cap`` 0 takes the
    fullest block's count rounded up to 128; a smaller one than that
    raises."""
    pr, pc, nr, nc = part.pr, part.pc, part.nr, part.nc
    s, r = senders.long(), receivers.long()
    blk = (r // nr) * pc + s // nc
    counts = torch.bincount(blk, minlength=part.p)
    full = int(counts.max())
    cap = cap or _round_up(max(full, 1), 128)
    if full > cap:
        raise ValueError(f"a block holds {full} edges, over cap={cap}")
    order = torch.sort(blk, stable=True).indices
    blk = blk[order]
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(blk.numel(), device=blk.device) - start[blk]
    esrc = torch.zeros(part.p, cap, dtype=torch.int32, device=blk.device)
    ridx = torch.zeros_like(esrc)
    esrc[blk, slot] = (s[order] % nc).to(torch.int32)
    ridx[blk, slot] = (r[order] % nr).to(torch.int32)
    return (esrc.reshape(pr, pc, cap), ridx.reshape(pr, pc, cap),
            counts.to(torch.int32).reshape(pr, pc))


def node_blocks(part: Partition2D, x: torch.Tensor) -> torch.Tensor:
    """Node data (n_orig, ...) in layout A, (pr, pc, chunk, ...): vertex v
    at processor v // chunk, zero past n_orig."""
    out = torch.zeros((part.n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[:part.n_orig] = x
    return out.reshape(part.pr, part.pc, part.chunk, *x.shape[1:])


def live_edges(part: Partition2D, esrc, ridx, nnz) -> Dict[str, torch.Tensor]:
    """Per live edge: ``col``, its sender in the expanded strips (pc * nc
    rows, strip j the column block C_j); ``blk_row``, its receiver in the
    blocks' row strips (p * nr rows, block-major); ``row``, its receiver
    in the gathered rows (pr * nr, strip i the row block R_i).  On
    ``meta`` every slot counts as live."""
    pr, pc, cap = esrc.shape
    if esrc.is_meta:
        pos = torch.arange(pr * pc * cap, device=esrc.device)
    else:
        live = torch.arange(cap, device=esrc.device) < nnz.unsqueeze(-1)
        pos = torch.nonzero(live.reshape(-1)).squeeze(1)
    blk = torch.div(pos, cap, rounding_mode="floor")
    r = ridx.reshape(-1)[pos].long()
    return {"col": esrc.reshape(-1)[pos].long() + (blk % pc) * part.nc,
            "blk_row": r + blk * part.nr,
            "row": r + torch.div(blk, pc, rounding_mode="floor") * part.nr}


def _expand(x: torch.Tensor, perm) -> torch.Tensor:
    """Layout A blocks (pr, pc, chunk, ...) -> the column strips, flat
    (pc * nc, ...): the transpose permute, then the tiled all-gather
    along "data" (every processor row holds the same strips)."""
    x_cj = collectives.all_gather_rows(collectives.ppermute(x, perm))
    return x_cj[0].reshape(-1, *x.shape[3:])


def _fold(partial: torch.Tensor, part: Partition2D) -> torch.Tensor:
    """Per-block row-strip sums (p * nr, ...) -> layout A by the combining
    reduce-scatter along "model"."""
    return collectives.psum_scatter_axis(
        partial.reshape(part.pr, part.pc, part.nr, *partial.shape[1:]),
        GRID_2D, COL)


def _psum_blocks(x: torch.Tensor) -> torch.Tensor:
    """psum over ("data", "model") of each processor's sum of ``x``."""
    return collectives.psum(x.reshape(*x.shape[:2], -1).sum(-1))


def gin2d_loss(part: Partition2D, n_layers: int) -> Callable:
    """loss(p, esrc, ridx, nnz, x, y, mask) of the 2D GIN: the masked
    mean node cross-entropy over every block."""
    perm = collectives.perm_index(part.transpose_perm(), "cpu")
    n_rows = part.p * part.nr

    def loss(p, esrc, ridx, nnz, x, y, mask):
        dev = x.device
        pm = tuple(t.to(dev) for t in perm)
        e = live_edges(part, esrc, ridx, nnz)
        h = x
        for l in range(n_layers):
            cols = _expand(h, pm)
            agg = _fold(gnn_mod.seg_sum(gnn_mod.gather(cols, e["col"]),
                                        e["blk_row"], n_rows), part)
            z = (1.0 + p[f"eps{l}"]) * h + agg
            z = torch.relu(z @ p[f"l{l}_w0"] + p[f"l{l}_b0"])
            h = torch.relu(z @ p[f"l{l}_w1"] + p[f"l{l}_b1"])
        logits = h @ p["head_w0"] + p["head_b0"]
        logp = F.log_softmax(logits.float(), -1)
        nll = -torch.gather(logp, -1, y[..., None].long())[..., 0]
        num = _psum_blocks(nll * mask)
        den = _psum_blocks(mask)
        return num / torch.clamp(den, min=1.0)
    return loss


def mace2d_loss(part: Partition2D, cfg) -> Callable:
    """loss(p, esrc, ridx, nnz, species, pos, target) of the 2D MACE: the
    squared error of the whole mesh's energy."""
    perm = collectives.perm_index(part.transpose_perm(), "cpu")
    n_rows = part.p * part.nr
    C, L = cfg.d_hidden, cfg.n_layers
    groups = (slice(0, 1), slice(1, 4), slice(4, 9))   # l = 0, 1, 2
    assert [int(mace_mod._LM_L[g].max()) for g in groups] == [0, 1, 2]

    def loss(p, esrc, ridx, nnz, species, pos, target):
        dev = pos.device
        pm = tuple(t.to(dev) for t in perm)
        G = torch.as_tensor(mace_mod.gaunt_table(), dtype=torch.float32,
                            device=dev)
        lmap = torch.as_tensor(mace_mod._LM_L, device=dev)
        e = live_edges(part, esrc, ridx, nnz)
        pos_c = _expand(pos, pm)                                # (pc nc, 3)
        # the row strips R_i, the same on every processor of a row
        pos_r = collectives.all_gather_cols(pos)[:, 0].reshape(-1, 3)
        # the scalar channel of h: its l > 0 components feed nothing
        h0 = p["embed"][species.long()]                # (pr, pc, chunk, C)
        rvec = gnn_mod.gather(pos_r, e["row"]) - gnn_mod.gather(pos_c,
                                                               e["col"])
        d = torch.linalg.vector_norm(rvec + 1e-12, dim=-1)
        u = rvec / torch.clamp(d, min=1e-9)[:, None]
        Y = mace_mod.real_sph_harm(u)                            # (E, 9)
        for l in range(L):
            rb = mace_mod.bessel_basis(d, cfg.n_rbf, 3.0)
            R = F.silu(rb @ p[f"rad_w0_{l}"]) @ p[f"rad_w1_{l}"]
            R = R.reshape(-1, C, 3)[:, :, lmap]                   # (E, C, 9)
            hs_c = _expand(h0, pm)                                # (pc nc, C)
            msg = R * Y[:, None, :] * gnn_mod.gather(hs_c, e["col"])[:, :,
                                                                     None]
            A = _fold(gnn_mod.seg_sum(msg, e["blk_row"], n_rows), part)
            B2 = mace_mod._gaunt_contract(A, A, G)
            B3 = mace_mod._gaunt_contract(B2, A, G)
            mix = p[f"mix_{l}"]
            m = torch.cat([sum(torch.einsum("...cm,cd->...dm", f[..., g],
                                            mix[o, li])
                               for o, f in enumerate((A, B2, B3)))
                           for li, g in enumerate(groups)], -1)
            h0 = h0 + m[..., 0]
            h0 = h0 + h0 @ p[f"upd_{l}"]
        e_node = F.silu(h0 @ p["out_w0"]) @ p["out_w1"]
        return (_psum_blocks(e_node) - target[0]) ** 2
    return loss


def build_mace2d_cell(shape_name: str, mesh) -> Cell:
    """MACE with the 2D expand/fold aggregation — the most
    collective-bound baseline cell of the JAX package's dry-run."""
    cfg = get_config("mace")
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    part, cap = _part_and_cap(shape, mesh)
    dev = mesh.device
    params = {k: v.requires_grad_() for k, v in
              mace_mod.init_mace(cfg, device=dev).items()}
    p_sh = {k: () for k in params}
    opt = AdamW()
    blk = (part.pr, part.pc)
    i32, f32 = torch.int32, torch.float32
    args = (params, opt.init(params), _t(blk + (cap,), i32, dev),
            _t(blk + (cap,), i32, dev), _t(blk, i32, dev),
            _t(blk + (part.chunk,), i32, dev),
            _t(blk + (part.chunk, 3), f32, dev), _t((1,), f32, dev))
    meta = {"family": "gnn", "model": "mace", "n_nodes": part.n,
            "n_edges": cap * part.p, "d_hidden": cfg.d_hidden,
            "n_layers": cfg.n_layers, "d_feat": 3, "variant": "2d-fold"}
    return Cell(_train_step(mace2d_loss(part, cfg), opt), args,
                (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh)) + (GRID,) * 5
                + ((None,),), f"mace-2d/{shape_name}", meta)


def build_gin2d_cell(shape_name: str, mesh) -> Cell:
    cfg = get_config("gin-tu")
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    part, cap = _part_and_cap(shape, mesh)
    dev = mesh.device
    d_feat = shape.d_feat or 16
    params = {k: v.requires_grad_() for k, v in
              gnn_mod.init_gin(cfg, d_feat, cfg.n_classes,
                               device=dev).items()}
    p_sh = {k: () for k in params}
    opt = AdamW()
    blk = (part.pr, part.pc)
    i32, f32 = torch.int32, torch.float32
    args = (params, opt.init(params), _t(blk + (cap,), i32, dev),
            _t(blk + (cap,), i32, dev), _t(blk, i32, dev),
            _t(blk + (part.chunk, d_feat), f32, dev),
            _t(blk + (part.chunk,), i32, dev),
            _t(blk + (part.chunk,), f32, dev))
    meta = {"family": "gnn", "model": "gin", "n_nodes": part.n,
            "n_edges": cap * part.p, "d_hidden": cfg.d_hidden,
            "n_layers": cfg.n_layers, "d_feat": d_feat, "variant": "2d-fold"}
    return Cell(_train_step(gin2d_loss(part, cfg.n_layers), opt), args,
                (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh)) + (GRID,) * 6,
                f"gin-tu-2d/{shape_name}", meta)
