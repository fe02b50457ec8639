"""Cell builders: every (architecture x input shape) pair of the JAX
package's ``launch/cells.py`` becomes a ``Cell`` (step function,
arguments, their mesh specs, label, model-FLOPs inputs) that the dry-run
counts (``launch/dryrun.py``) and that a card runs with real tensors of
the same shapes.

The arguments are made on the mesh's device: PyTorch's ``meta`` device
in the dry-run, where nothing is allocated and every step traces its
shapes.  Parameters come from the port's ``init_params``, ``init_gin``
and the like, optimizer state from ``AdamW.init``.  ``specs`` is the
port's form of the JAX package's ``in_shardings``: for each argument
tensor a tuple with, per dim, the mesh axes that split it (None, a name
or a tuple of names); it reckons per-device argument bytes only
(``per_device_bytes``).  The simulated mesh runs every shard on one
device, so a step computes the whole mesh's work: the LM, GNN and recsys
cells issue no collective (the JAX package's GSPMD inserts them from the
shardings; the port has none to insert), while the MoE layers' expert
exchange, the BFS steps and the optimized cells
(``launch/optimized.py``) record theirs.

Cell kinds:
  LM      : train_step (loss+grad+AdamW), prefill, decode (KV cache;
            the sliding window's ring cache of ``swa_window`` slots)
  GNN     : train_step (full-graph / sampled / batched)
  recsys  : train_step, serve, retrieval scoring (kernel 8, and 8b in
            training: the port's lookup, on one device)
  BFS     : one direction-optimizing level (a top-down then a bottom-up
            step on the dense LocalOps) a cell; ``level_only`` is the
            JAX package's level cell.  The whole search cannot be traced
            on ``meta``: its level loop reads each level's masses to the
            host (``core/decomp.py``), so the whole-search cell runs the
            graph-less plan's checks (``plan_for_part``) and one level
            from its root.

Decode cells trace their step at the cache's last position (the
attention over the whole cache, as the JAX package's program computes it
over every slot); on a real device the position tensor is read.

``_gnn_loss`` picks the loss of a (GNN arch, shape) pair as the JAX
package does: MACE's energy regression, MeshGraphNet's regression on the
first three outputs, the graph readout's cross-entropy on batched
shapes, the masked node cross-entropy otherwise.  ``sampled_batch`` is
the concrete form of ``_gnn_sampled_cell``'s step for ``minibatch_lg``:
``khop_sample`` from the CSR, then the batch it builds, on real tensors
and an explicit generator.

``deterministic`` runs a step with ``torch.use_deterministic_algorithms``
on, so that the aggregation's ``index_add`` and the gathers' gradients
reduce in a fixed order on a card (their default is atomics), and a
resumed run repeats the uninterrupted one bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (BFSConfig, BFSShape, GNNConfig,
                                      GNNShape, LMConfig, LMShape,
                                      RecsysConfig, RecsysShape, get_config)
from repro_torch.core import collectives
from repro_torch.core import steps as bfs_steps
from repro_torch.core.engine import plan_for_part
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.core.local_ops import get_local_ops
from repro_torch.core.partition import make_partition
from repro_torch.graph.datasets import _edges_for
from repro_torch.graph.sampler import khop_sample
from repro_torch.kernels.epilogue.ops import Front
from repro_torch.launch.mesh import make_generator
from repro_torch.models import autoint as ai
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import mace as mace_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import ShardCtx
from repro_torch.optim.adamw import AdamW, AdamWState

SAMPLED_D_FEAT = 128      # the JAX cell's feature width on minibatch_lg


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, then the
    setting it found.  cuBLAS's workspace warning is silenced: a GEMM of
    one shape repeats in one process; the reductions it would not cover
    are the scatters, which this mode orders."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def deterministic_step(step_fn: Callable) -> Callable:
    """``step_fn`` run under ``deterministic()`` (the unwrapped function is
    its ``__wrapped__``)."""
    @functools.wraps(step_fn)
    def step(state, batch):
        with deterministic():
            return step_fn(state, batch)
    return step


def _gnn_loss(cfg: GNNConfig, shape: GNNShape, n: int, n_graphs: int,
              d_in: int) -> Tuple[Callable, Callable]:
    """(init(seed=0, device="cpu") -> params, loss_fn(params, batch))."""
    if cfg.model == "mace":
        def loss_fn(p, b):
            e = mace_mod.mace_energy(p, cfg, b["species"], b["pos"],
                                     b["senders"], b["receivers"],
                                     b["edge_mask"], b["graph_ids"],
                                     n_graphs)
            return torch.mean((e - b["targets_g"]) ** 2)

        def init(seed=0, device="cpu"):
            return mace_mod.init_mace(cfg, seed=seed, device=device)
        return init, loss_fn
    init, apply = gnn_mod.build_gnn_apply(cfg, d_in, cfg.n_classes)

    def loss_fn(p, b):
        out = apply(p, b)
        if cfg.model == "meshgraphnet":
            return torch.mean((out[:, :3] - b["targets"]) ** 2)
        if shape.kind == "batched":
            return gnn_mod.graph_readout_xent(out, b["graph_ids"],
                                              b["labels"], n_graphs)
        return gnn_mod.node_xent(out, b["labels"], b["node_mask"])
    return init, loss_fn


def sampled_sizes(shape: GNNShape) -> Tuple[int, int]:
    """(n_sub, E_sub) of the occurrence tree of one sampled batch."""
    Bs, (f0, f1) = shape.batch_nodes, shape.fanout
    return Bs * (1 + f0 + f0 * f1), Bs * (f0 + f0 * f1)


def sampled_graph(shape: GNNShape, n_classes: int, seed: int = 0,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """The full graph a sampled shape draws from, on ``device``: its CSR
    (``row_ptr`` (N+1,), ``col_idx`` (M,), int32: ``_edges_for``'s edges
    sorted by source, the pointers from a count), node features (N, 128)
    float32 and labels (N,) int32 from numpy's ``default_rng(seed)``."""
    N, M = shape.n_nodes, shape.n_edges
    src, dst = _edges_for(N, M, seed, device=device)
    order = torch.sort(src, stable=True).indices
    col_idx = dst[order]
    del order, dst
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=src.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(src, minlength=N), 0)
    del src
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, SAMPLED_D_FEAT)).astype(np.float32)
    labels = rng.integers(0, n_classes, N).astype(np.int32)
    dev = row_ptr.device
    return {"row_ptr": row_ptr, "col_idx": col_idx,
            "feats": torch.from_numpy(feats).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def sampled_batch(gen: torch.Generator, graph: Dict[str, torch.Tensor],
                  seeds: torch.Tensor, fanouts: Sequence[int]
                  ) -> Dict[str, torch.Tensor]:
    """One ``minibatch_lg`` batch: the occurrence tree of ``seeds`` and
    the node and edge data the JAX cell's step builds from it."""
    sub = khop_sample(gen, graph["row_ptr"], graph["col_idx"], seeds,
                      fanouts)
    ids = sub["node_ids"].long()
    n_sub, bs = ids.shape[0], sub["n_seed"]
    x = graph["feats"][ids]
    pos = x[:, :3]
    dev = x.device
    s, r = sub["senders"], sub["receivers"]
    return {
        "senders": s, "receivers": r, "edge_mask": sub["edge_mask"],
        "x": x,
        "graph_ids": torch.zeros(n_sub, dtype=torch.int32, device=dev),
        "labels": graph["labels"][ids],
        "node_mask": (torch.arange(n_sub, device=dev) < bs).float(),
        "species": (ids % 8).to(torch.int32),
        "pos": pos,
        "targets": pos * 0.5,
        "targets_g": torch.zeros(1, dtype=torch.float32, device=dev),
        "e_feat": torch.cat([pos[s] - pos[r],
                             torch.ones(s.shape[0], 1, device=dev)], 1),
    }


def sampled_loss(cfg: GNNConfig, shape: GNNShape
                 ) -> Tuple[Callable, Callable]:
    """(init, loss_fn(params, inputs)) of the sampled cell: ``inputs``
    holds the full ``graph``, the step's ``seeds`` and the ``sample_seed``
    of the sampler's generator (on the graph's device)."""
    n_sub, E_sub = sampled_sizes(shape)
    sub = GNNShape("sub", n_sub, E_sub, SAMPLED_D_FEAT)
    init, _ = _gnn_loss(cfg, sub, n_sub, shape.batch_nodes, SAMPLED_D_FEAT)
    _, loss_b = _gnn_loss(cfg, sub, n_sub, 1, SAMPLED_D_FEAT)

    def loss_fn(p, inputs):
        graph = inputs["graph"]
        gen = torch.Generator(graph["row_ptr"].device).manual_seed(
            int(inputs["sample_seed"]))
        return loss_b(p, sampled_batch(gen, graph, inputs["seeds"],
                                       shape.fanout))
    return init, loss_fn


# ---------------------------------------------------------------------------
# Cells: shared pieces
# ---------------------------------------------------------------------------


class Cell(NamedTuple):
    fn: Callable
    args: Tuple[Any, ...]          # tensors (dicts, AdamWState) on the mesh
    specs: Any                     # per tensor, the mesh axes of each dim
    label: str
    meta: Dict[str, Any]           # model-flops accounting inputs


def _t(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


def _round_up(x, q):
    return ((x + q - 1) // q) * q


def _dp(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def _flat(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def per_device_bytes(args, specs, mesh) -> int:
    """The bytes one device holds of ``args`` under ``specs``: each
    tensor's bytes over the product of the axes that split its dims (a
    spec of None, or a missing one, is replicated)."""
    if isinstance(args, torch.Tensor):
        n = args.numel() * args.element_size()
        for entry in (specs or ()):
            n //= _axes_size(mesh, entry)
        return n
    if isinstance(args, dict):
        return sum(per_device_bytes(v, (specs or {}).get(k), mesh)
                   for k, v in args.items())
    if isinstance(args, (tuple, list)):
        specs = specs if specs is not None else (None,) * len(args)
        return sum(per_device_bytes(a, s, mesh) for a, s in zip(args, specs))
    return 0


def _trainable(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(v.is_floating_point())
            for k, v in params.items()}


def _train_step(loss_fn: Callable, opt: AdamW) -> Callable:
    """step(p, ost, *batch) -> (p2, ost2, loss): the loss's gradient in
    every floating parameter, then the optimizer's update."""
    def step(p, ost, *batch):
        with torch.enable_grad():
            loss = loss_fn(p, *batch)
            keys = [k for k, v in p.items() if v.requires_grad]
            grads = torch.autograd.grad(loss, [p[k] for k in keys])
        g = dict(zip(keys, grads))
        g.update({k: torch.zeros_like(v) for k, v in p.items()
                  if k not in g})
        p2, ost2 = opt.update(g, ost, p)
        return p2, ost2, loss.detach()
    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def lm_param_specs(cfg: LMConfig, ctx: ShardCtx) -> Dict[str, tuple]:
    """The JAX package's ``param_specs`` as axis tuples: heads over
    "model" where they divide it (else the d_model contraction), FSDP's
    extra split of the free dim over the data axes, experts over "model"
    (or their d_ff where fewer experts than shards)."""
    tp, dp, tpn = ctx.tp, ctx.dp, ctx.tp_size
    head_tp = tp if (tp and cfg.n_heads % tpn == 0) else None
    kv_tp = tp if (tp and cfg.n_kv_heads % tpn == 0) else None
    d_tp = None if head_tp else tp
    dkv_tp = None if kv_tp else tp
    fs = dp if (cfg.fsdp and dp) else None
    specs = {
        "embed": (tp, None), "final_ln": (None,),
        "wq": (None, d_tp, head_tp if head_tp else fs),
        "wk": (None, dkv_tp, kv_tp if kv_tp else fs),
        "wv": (None, dkv_tp, kv_tp if kv_tp else fs),
        "wo": (None, head_tp if head_tp else tp, fs),
        "ln1": (None, None), "ln2": (None, None),
    }
    if cfg.moe is None:
        specs.update(wg=(None, fs, tp), wu=(None, fs, tp), wd=(None, tp, fs))
    else:
        dpa = dp if dp else None
        if tp and cfg.moe.n_experts % tpn == 0:
            specs.update(router=(None, None, None), wg_e=(None, tp, dpa, None),
                         wu_e=(None, tp, dpa, None),
                         wd_e=(None, tp, None, dpa))
        else:
            specs.update(router=(None, None, None), wg_e=(None, None, dpa, tp),
                         wu_e=(None, None, dpa, tp),
                         wd_e=(None, None, tp, dpa))
    return specs


def _cache_spec(cfg: LMConfig, mesh, batch: int) -> tuple:
    dp = _dp(mesh)
    dp_ok = batch % math.prod(mesh.shape[a] for a in dp) == 0 if dp \
        else False
    bspec = dp if dp_ok else None
    if cfg.n_kv_heads % mesh.shape.get("model", 1) == 0:
        return (None, bspec, None, "model", None)
    return (None, bspec, "model", None, None)


def build_lm_cell(cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    if shape.kind != "train" and cfg.fsdp:
        # FSDP is a training-memory optimization (optimizer moments);
        # serving keeps plain TP weights
        cfg = dataclasses.replace(cfg, fsdp=False)
    ctx = ShardCtx(mesh=mesh)
    dev = mesh.device
    dp = _dp(mesh)
    B, S = shape.global_batch, shape.seq_len
    dp_total = math.prod(mesh.shape[a] for a in dp) if dp else 1
    tok_b = dp if (dp and B % dp_total == 0) else None
    params = tf.init_params(cfg, device=dev)
    p_sh = lm_param_specs(cfg, ctx)
    label = f"{cfg.arch}/{shape.name}"
    meta = {"family": "lm", "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "tokens": B * S, "kind": shape.kind,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "scan_layers": True, "global_batch": B, "seq_len": S}

    if shape.kind == "train":
        opt = AdamW(state_dtype=cfg.opt_state_dtype)
        params = _trainable(params)
        opt_state = opt.init(params)
        toks = _t((B, S), torch.int32, dev)
        step = _train_step(
            lambda p, tokens, labels: tf.lm_loss(p, tokens, labels, cfg, ctx),
            opt)
        return Cell(step, (params, opt_state, toks, toks.clone()),
                    (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh),
                     (tok_b, None), (tok_b, None)), label, meta)

    cache_len = S
    if shape.kind == "decode" and cfg.swa_window:
        cache_len = min(S, cfg.swa_window)       # SWA ring window cache
    cache = tf.init_kv_cache(cfg, B, cache_len, device=dev)
    cspec = _cache_spec(cfg, mesh, B)
    cache_sh = {k: cspec for k in cache}

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(p, tokens, c):
            return tf.prefill(p, tokens, c, cfg, ctx)

        return Cell(prefill_step, (params, _t((B, S), torch.int32, dev),
                                   cache),
                    (p_sh, (tok_b, None), cache_sh), label,
                    {**meta, "tokens": B * S})

    @torch.no_grad()
    def dec_step(p, c, t, pos):
        at = cache_len - 1 if pos.is_meta else int(pos)
        return tf.decode_step(p, c, t, at, cfg, ctx)

    return Cell(dec_step, (params, cache, _t((B, 1), torch.int32, dev),
                           _t((), torch.int32, dev)),
                (p_sh, cache_sh, (tok_b, None), ()), label,
                {**meta, "tokens": B, "kv_len": cache_len})


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def build_gnn_cell(cfg: GNNConfig, shape: GNNShape, mesh) -> Cell:
    dev = mesh.device
    flat = _flat(mesh)
    n_dev = mesh.size
    label = f"{cfg.arch}/{shape.name}"

    if shape.kind == "sampled":
        return _gnn_sampled_cell(cfg, shape, mesh, label)

    if shape.kind == "batched":
        n_graphs = shape.batch_graphs
        N = _round_up(n_graphs * shape.n_nodes, n_dev)
        E = _round_up(n_graphs * shape.n_edges, n_dev)
        d_feat = 16
    else:
        n_graphs = 1
        N = _round_up(shape.n_nodes, n_dev)     # padded isolated vertices
        E = _round_up(shape.n_edges, n_dev)
        d_feat = shape.d_feat or 16

    espec = (flat,)
    nspec = (flat,) if N > 500_000 else (None,)
    i32, f32 = torch.int32, torch.float32
    batch = {
        "senders": _t((E,), i32, dev), "receivers": _t((E,), i32, dev),
        "edge_mask": _t((E,), f32, dev), "graph_ids": _t((N,), i32, dev),
        "labels": _t((n_graphs if shape.kind == "batched" else N,), i32,
                     dev),
        "node_mask": _t((N,), f32, dev),
    }
    b_sh = {"senders": espec, "receivers": espec, "edge_mask": espec,
            "graph_ids": nspec,
            "labels": nspec if n_graphs == 1 else (None,),
            "node_mask": nspec}
    if cfg.model == "mace":
        batch.update(species=_t((N,), i32, dev), pos=_t((N, 3), f32, dev),
                     targets_g=_t((n_graphs,), f32, dev))
        b_sh.update(species=nspec, pos=nspec, targets_g=(None,))
    elif cfg.model == "meshgraphnet":
        batch.update(x=_t((N, d_feat), f32, dev), e_feat=_t((E, 4), f32, dev),
                     targets=_t((N, 3), f32, dev))
        b_sh.update(x=nspec, e_feat=espec, targets=nspec)
    else:
        batch["x"] = _t((N, d_feat), f32, dev)
        b_sh["x"] = nspec

    init, loss_fn = _gnn_loss(cfg, shape, N, n_graphs, d_feat)
    params = _trainable(init(device=dev))
    p_sh = {k: () for k in params}
    opt = AdamW()
    meta = {"family": "gnn", "model": cfg.model, "n_nodes": N, "n_edges": E,
            "d_hidden": cfg.d_hidden, "n_layers": cfg.n_layers,
            "d_feat": d_feat}
    return Cell(_train_step(loss_fn, opt), (params, opt.init(params), batch),
                (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh), b_sh), label,
                meta)


def _gnn_sampled_cell(cfg: GNNConfig, shape: GNNShape, mesh, label) -> Cell:
    """minibatch_lg: neighbor-sample + train, fused into one step.  The
    sampler draws from a ``torch.Generator`` seeded 0: the step's (2,)
    uint32 key (the JAX cell's threefry key) is not read, which on a card
    would be a host read."""
    dev = mesh.device
    N, M = shape.n_nodes, shape.n_edges
    Bs, fan = shape.batch_nodes, shape.fanout
    d_feat = SAMPLED_D_FEAT
    n_sub, E_sub = sampled_sizes(shape)
    sub = GNNShape("sub", n_sub, E_sub, d_feat)
    init, _ = _gnn_loss(cfg, sub, n_sub, Bs, d_feat)
    _, loss_b = _gnn_loss(cfg, sub, n_sub, 1, d_feat)
    params = _trainable(init(device=dev))
    p_sh = {k: () for k in params}
    opt = AdamW()
    i32 = torch.int32
    args = (params, opt.init(params),
            _t((N + 1,), i32, dev),               # row_ptr
            _t((M,), i32, dev),                   # col_idx
            _t((N, d_feat), torch.float32, dev),  # features
            _t((N,), i32, dev),                   # labels (full)
            _t((Bs,), i32, dev),                  # seeds
            _t((2,), torch.uint32, dev))          # rng key
    shard = (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh)) + ((None,),) * 6

    def loss_fn(p, row_ptr, col_idx, feats, labels, seeds, key):
        graph = {"row_ptr": row_ptr, "col_idx": col_idx, "feats": feats,
                 "labels": labels}
        gen = make_generator(row_ptr.device, 0)
        return loss_b(p, sampled_batch(gen, graph, seeds, fan))

    meta = {"family": "gnn", "model": cfg.model, "n_nodes": n_sub,
            "n_edges": E_sub, "d_hidden": cfg.d_hidden,
            "n_layers": cfg.n_layers, "d_feat": d_feat, "sampled": True}
    return Cell(_train_step(loss_fn, opt), args, shard, label, meta)


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def build_recsys_cell(cfg: RecsysConfig, shape: RecsysShape, mesh) -> Cell:
    """AutoInt's cells on kernel 8 (and 8b's table gradient in training):
    the port's lookup is one device's, so the table's "model" split in
    ``specs`` counts its bytes only."""
    dev = mesh.device
    dp = _dp(mesh)
    label = f"{cfg.arch}/{shape.name}"
    train = shape.kind == "train"
    params = {k: v.detach() for k, v in
              ai.AutoInt(cfg, device=dev).params().items()}
    p_sh = {k: (("model", None) if k == "table" else ()) for k in params}
    B = shape.batch
    dp_total = math.prod(mesh.shape[a] for a in dp) if dp else 1
    bspec = dp if B % max(dp_total, 1) == 0 and B >= dp_total else None
    meta = {"family": "recsys", "batch": B, "n_fields": cfg.n_sparse,
            "embed_dim": cfg.embed_dim, "kind": shape.kind}
    idx = _t((B, cfg.n_sparse), torch.int32, dev)

    if train:
        params = _trainable(params)
        opt = AdamW()
        step = _train_step(
            lambda p, i, lab: ai.bce_loss(p, cfg, i, lab), opt)
        return Cell(step, (params, opt.init(params), idx,
                           _t((B,), torch.float32, dev)),
                    (p_sh, AdamWState(step=(), mu=p_sh, nu=p_sh),
                     (bspec, None), (bspec,)), label, meta)

    if shape.kind == "serve":
        @torch.no_grad()
        def serve_step(p, i):
            return torch.sigmoid(ai.forward(p, cfg, i))

        return Cell(serve_step, (params, idx), (p_sh, (bspec, None)), label,
                    meta)

    NC = shape.n_candidates
    d_user = cfg.n_heads * cfg.d_attn

    @torch.no_grad()
    def retrieval_step(p, i, cand):
        u = ai.interact(p, cfg, ai.embed(p, cfg, i)).mean(dim=1)
        return u @ cand.T

    return Cell(retrieval_step, (params, idx,
                                 _t((NC, d_user), torch.float32, dev)),
                (p_sh, (None, None), ("model", None)), label,
                {**meta, "n_candidates": NC})


# ---------------------------------------------------------------------------
# BFS cells (the paper's workload)
# ---------------------------------------------------------------------------


def _bfs_graph_specs(part, cap, cap_seg, keys, dev) -> Dict[str, torch.Tensor]:
    nr, nc, chunk, pr, pc = part.nr, part.nc, part.chunk, part.pr, part.pc
    full = {
        "edge_src": (cap,), "row_idx": (cap,), "nnz": (),
        "deg_A": (chunk,), "col_idx": (cap + cap_seg,),
        "edge_dst": (cap + cap_seg,),
        "row_ptr": (nr + 1,), "seg_ptr": (pc + 1,),
        "col_ptr": (nc + 1,), "jc": (cap,), "cp": (cap + 1,), "nzc": (),
    }
    return {k: _t((pr, pc) + full[k], torch.int32, dev) for k in keys}


def _level_args(cfg: BFSConfig, part, cap: int, cap_seg: int, dev
                ) -> bfs_steps.LevelArgs:
    """The dense LocalOps' level context, uninstrumented: a level cell's
    counters feed nothing, and the JAX program's compiler drops their
    reductions.  The bottom-up windows split each block's capacity
    evenly over its pc segments (a trace on ``meta`` cannot read the
    graph's ``seg_ptr``)."""
    ops = get_local_ops("2d", "dense", cfg.storage)
    step = cap // part.pc
    seg_ptr = np.broadcast_to(np.arange(part.pc + 1, dtype=np.int64) * step,
                              (part.pr, part.pc, part.pc + 1))
    return bfs_steps.LevelArgs(
        part=part, fold_mode=cfg.fold_mode,
        perm=collectives.perm_index(part.transpose_perm(), dev),
        seg_ptr=seg_ptr, ops=ops, cap_seg=cap_seg, instrument=False,
        use_edge_dst=cfg.use_edge_dst, compact_updates=cfg.compact_updates)


def _one_level(g, pi, front, args) -> Tuple[torch.Tensor, torch.Tensor]:
    """A top-down step, then a bottom-up step from its frontier (a
    ``Front``; the loop's host values are not needed by the dense 2D
    steps' results)."""
    lv = {"n_f": 0.0, "m_f": 0.0}
    pi1, f1, _ = bfs_steps.topdown_level(g, pi, front, args, lv)
    pi2, f2, _ = bfs_steps.bottomup_level(g, pi1, f1, args, lv)
    return pi2, f2


def build_bfs_cell(cfg: BFSConfig, shape: BFSShape, mesh,
                   level_only: bool = False) -> Cell:
    dev = mesh.device
    pr, pc = mesh.shape["data"], mesh.shape["model"]
    n = 1 << shape.scale
    part = make_partition(n, pr, pc, align=128)
    p = part.p
    # capacity model: symmetrized+deduped R-MAT keeps ~0.94 of 2*ef*n edges;
    # R-MAT block skew needs ~1.4x headroom at this grid size
    m_est = int(2 * shape.degree * n * 0.94)
    cap = _round_up(int(m_est / p * 1.4), 128)
    cap_seg = _round_up(int(cap / pc * 2.0), 128)
    label = f"{cfg.arch}/{shape.name}" + ("/level" if level_only else "")
    meta = {"family": "bfs", "n": part.n, "m": m_est, "pr": pr, "pc": pc,
            "scale": shape.scale, "storage": cfg.storage}
    grid = ("data", "model")
    args_l = _level_args(cfg, part, cap, cap_seg, dev)

    if level_only:
        keys = args_l.ops.keys
        g_specs = _bfs_graph_specs(part, cap, cap_seg, keys, dev)
        pi = _t((pr, pc, part.chunk), torch.int32, dev)
        fr = _t((pr, pc, part.chunk), torch.bool, dev)

        def level_fn(g, pi, front):
            # the JAX package's level cell takes the bool frontier
            return _one_level(g, pi, Front(pack_bits(front), None), args_l)
        return Cell(level_fn, (g_specs, pi, fr),
                    ({k: grid for k in g_specs}, grid, grid), label, meta)

    # the engine's plan layer owns dispatch and validation: the cell runs
    # its checks on a graph-less plan
    plan = plan_for_part(part, cfg, mesh, cap_seg=cap_seg)
    g_specs = _bfs_graph_specs(part, cap, cap_seg, plan.keys, dev)
    g_sh = {k: grid for k in g_specs}

    def from_root(g, root):
        # the search's start: pi all -1 through the level epilogue with
        # the root (a device scalar) as the one candidate
        pi = torch.full((pr, pc, part.chunk), -1, dtype=torch.int32,
                        device=root.device)
        cand = torch.full_like(pi, INT_INF)
        cand.view(-1).index_put_((root.reshape(1).long(),), root.reshape(1))
        front = args_l.ops.epilogue(pi, g["deg_A"], cand)
        return _one_level(g, pi, front, args_l)

    if "pod" in mesh.axis_names and kwargs_get_multiroot(cfg):
        pods = mesh.shape["pod"]

        def batch_fn(g, roots):
            return [from_root(g, roots[k]) for k in range(pods)]
        return Cell(batch_fn, (g_specs, _t((pods,), torch.int32, dev)),
                    (g_sh, ("pod",)), label + "/multiroot",
                    {**meta, "n_roots": pods})
    return Cell(from_root, (g_specs, _t((), torch.int32, dev)), (g_sh, ()),
                label, meta)


def kwargs_get_multiroot(cfg) -> bool:
    return getattr(cfg, "arch", "").endswith("multiroot")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

SKIPPED_CELLS = {
    # long_500k needs sub-quadratic attention; these are pure full-attention
    # archs (DESIGN.md §Arch-applicability) — mixtral (SWA) runs it.
    ("stablelm-3b", "long_500k"), ("smollm-135m", "long_500k"),
    ("starcoder2-7b", "long_500k"), ("qwen3-moe-30b-a3b", "long_500k"),
}
SKIP_REASON = ("long_500k on pure full-attention arch "
               "(DESIGN.md §Arch-applicability)")


def build_cell(arch: str, shape_name: str, mesh, **kw) -> Optional[Cell]:
    if arch == "gin-tu-2d":
        from repro_torch.launch.optimized import build_gin2d_cell
        return build_gin2d_cell(shape_name, mesh)
    if arch == "mace-2d":
        from repro_torch.launch.optimized import build_mace2d_cell
        return build_mace2d_cell(shape_name, mesh)
    cfg = get_config(arch)
    if (arch, shape_name) in SKIPPED_CELLS:
        return None
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    if cfg.kind == "lm":
        return build_lm_cell(cfg, shape, mesh)
    if cfg.kind == "gnn":
        return build_gnn_cell(cfg, shape, mesh)
    if cfg.kind == "recsys":
        return build_recsys_cell(cfg, shape, mesh)
    if cfg.kind == "bfs":
        return build_bfs_cell(cfg, shape, mesh, **kw)
    raise ValueError(arch)


def all_cells():
    """(arch, shape) ids for the full matrix (incl. skips -> None)."""
    out = []
    for arch in ("stablelm-3b", "smollm-135m", "starcoder2-7b",
                 "qwen3-moe-30b-a3b", "mixtral-8x22b"):
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            out.append((arch, s))
    for arch in ("mace", "gin-tu", "gat-cora", "meshgraphnet"):
        for s in ("full_graph_sm", "minibatch_lg", "ogb_products",
                  "molecule"):
            out.append((arch, s))
    for s in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        out.append(("autoint", s))
    return out


def bfs_cells():
    return [("bfs-rmat", s) for s in ("scale22", "scale26", "scale30")]


# the JAX package's hill-climb records (tests/test_dryrun_artifacts.py):
# (arch, shape, multi_pod)
HILLCLIMB_CELLS = (
    ("bfs-rmat-i1", "scale30", False), ("bfs-rmat-i2", "scale30", False),
    ("bfs-rmat-opt", "scale30", False), ("gin-tu-2d", "ogb_products", False),
    ("mace-2d", "ogb_products", False),
    ("bfs-rmat-multiroot", "scale22", True),
    ("qwen3-moe-r2", "train_4k", False), ("qwen3-moe-r3", "train_4k", False))
