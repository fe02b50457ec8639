"""Per-level BFS steps of the sparse-exchange 1D strips ("1ds"): the
1D baseline with the frontier exchanged as owner-directed vertex ids
instead of the dense n-bit bitmap (Buluc & Madduri's formulation).

Each owner compacts its frontier into a bucket of ``cap_x`` ids
(``PlanStatics.cap_x``, planned by ``comm_model.plan_cap_x``) and one
tiled allgather delivers every bucket to every strip: n_f*(p-1) words
on the wire, a win while the frontier is small.  When any owner's send
set overflows its bucket, the whole level falls back to the dense
bitmap, so ids are never truncated.  On the simulated mesh the
overflow predicate (the max over strips of the send count) is read to
the host once per top-down level, together with the send total the
wire counter needs.  The ``instrument=False`` loop hands the predicate
in as ``lv["over"]``, read with the previous level's masses
(``decomp.reduce_state``), so its levels skip that read and
report no wire (``None``).  Bottom-up levels always take the dense
bitmap.

Two reductions ride the exchange:

  * the sieve: the owner drops already-visited vertices from its send
    set (``send = front & ~visited``) before packing, the overflow count
    and the fallback bitmap.  In the level loop the frontier is fresh,
    so the sieve removes nothing and parents do not move;
  * the codec: ``frontier_codec="packed"`` ships count-prefixed local
    offsets bit-packed at ``codec_bits(chunk)`` bits
    (``kernels/frontier_codec``, through the LocalOps entry's
    ``encode``/``decode``: the kernels in a kernel session, their plain
    versions in a dense one), which the receiver rebases by the
    bucket's position.  ``wire_expand`` then takes the compressed closed
    form ``comm_model.compressed_expand_1d_words``; ``use_expand`` stays
    in raw-id words.

Every strip receives the same gathered buffer, so it is decoded once
per exchange.  Local discovery is that of "1d": the exchange rebuilds
the same packed frontier bitmap.  The steps read the "1d" per-plan
context, ``LevelArgs1D``, whose ``cap_x`` and ``codec`` fields are the
sparse exchange's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, comm_model
from repro_torch.core.collectives import STRIPS
from repro_torch.core.frontier import pack_bits, pack_ids, unpack_ids
from repro_torch.core.steps_1d import (LevelArgs1D, update,
                                       bottomup_level_1d,
                                       pipelined_expand_consume,
                                       topdown_counters)

CODECS = ("none", "packed")

_F32 = np.float32


def _send_counts(counts: torch.Tensor) -> Tuple[int, np.float32]:
    """The one host read of an exchange: the largest send count (the
    overflow predicate's pmax) and the float32 send total (the wire
    counter's psum)."""
    n_max, n_f = torch.stack([collectives.pmax(counts, STRIPS),
                              collectives.psum(counts, STRIPS,
                                               "counter")]).tolist()
    return n_max, _F32(n_f)


def sparse_exchange_1d(front: torch.Tensor, cap_x: int, part, ops,
                       visited: torch.Tensor = None, codec: str = "none",
                       over: bool = None):
    """Owner-directed sparse exchange of the ``(p, chunk)`` frontier with
    the dense fallback; the packed codec runs the LocalOps entry ``ops``'s
    ``encode`` and ``decode``.  Returns ``(f_words (n/32,) int32, wire,
    overflowed)``: the bitmap every strip rebuilds, and the float32
    words shipped (compressed or raw ids, or the bitmap's words).

    ``over``, the overflow predicate, may come in worked out: the fast
    loop reads it with the previous level's masses.  Then the exchange
    makes no host read of its own and ``wire`` is None: an uninstrumented
    exchange reports no number rather than a 0 that would read as one."""
    if codec not in CODECS:
        raise ValueError(f"unknown frontier codec {codec!r}; "
                         f"expected one of {CODECS}")
    p, chunk, n = part.p, part.chunk, part.n
    send = front if visited is None else front & ~visited
    n_local = send.sum(dim=1, dtype=torch.int32) \
        if over is None or codec == "packed" else None
    n_f = None
    if over is None:
        n_max, n_f = _send_counts(n_local)
        over = n_max > cap_x
    if over:
        f_words = collectives.all_gather_tiled(pack_bits(send), STRIPS,
                                               "dense")
    elif codec == "packed":
        buf = ops.encode(pack_ids(send, cap_x, 0, chunk), n_local, chunk)
        recv = collectives.all_gather_tiled(buf, STRIPS, "sparse")
        f_words = unpack_ids(ops.decode(recv, chunk, cap_x, n, p), n)
    else:
        base = torch.arange(p, dtype=torch.int32,
                            device=front.device)[:, None] * chunk
        recv = collectives.all_gather_tiled(pack_ids(send, cap_x, base, n),
                                            STRIPS, "sparse")
        f_words = unpack_ids(recv, n)
    if n_f is None:
        wire = None
    elif over:
        wire = _F32(comm_model.expand_1d_level_words(n, p))
    else:
        wire = comm_model.compressed_expand_1d_words(
            n_f, p, comm_model.codec_bits(chunk)) if codec == "packed" \
            else comm_model.sparse_expand_1d_words(n_f, p)
    return f_words, wire, over


def _pipelined_topdown_1ds(g, send: torch.Tensor, args: LevelArgs1D,
                           over: bool = None):
    """The pipelined sparse top-down expand (``expand_chunks = C > 1``):
    each owner's chunk splits into C sub-ranges of ``sub = chunk/C``
    vertices, each exchanged as its own bucket of ``cap_x/C`` ids and
    consumed by a partial SpMSV.  The level overflows when any owner's
    send set exceeds ``cap_x/C`` in any sub-range, and then takes the
    chunked dense expand.  Every sub-exchange decodes to the owner-major
    ``(p * w_sub,)`` sub-chunk words: raw ids rebase to ``owner*sub +
    local``, and the packed codec decodes with ``chunk=sub, n=p*sub`` so
    its bucket-position rebase lands there itself (offsets narrow to
    ``codec_bits(sub)`` bits, one count word per sub-bucket).  ``over``
    may come in worked out, as in ``sparse_exchange_1d``.

    Returns (cand, ex, wire); ``wire`` is None when ``over`` came in."""
    part = args.part
    c = args.expand_chunks
    p, chunk, n = part.p, part.chunk, part.n
    sub = chunk // c
    cap_c = args.cap_x // c
    masks = send.reshape(p, c, sub)
    counts = masks.sum(dim=2, dtype=torch.int32) \
        if over is None or args.codec == "packed" else None
    n_f = None
    if over is None:
        n_max, n_f = _send_counts(counts)
        over = n_max > cap_c

    if over:
        words = pack_bits(send).reshape(p, c, sub // 32)

        def sub_gather(k):
            return collectives.all_gather_tiled(words[:, k], STRIPS, "dense")
    elif args.codec == "packed":
        ops = args.ops

        def sub_gather(k):
            buf = ops.encode(pack_ids(masks[:, k], cap_c, 0, sub),
                             counts[:, k].contiguous(), sub)
            recv = collectives.all_gather_tiled(buf, STRIPS, "sparse")
            return unpack_ids(ops.decode(recv, sub, cap_c, p * sub, p),
                              p * sub)
    else:
        base = torch.arange(p, dtype=torch.int32,
                            device=send.device)[:, None] * chunk

        def sub_gather(k):
            ids = collectives.all_gather_tiled(
                pack_ids(masks[:, k], cap_c, base + k * sub, n), STRIPS,
                "sparse")
            owner = torch.div(ids, chunk, rounding_mode="floor")
            pos = owner * sub + (ids - owner * chunk - k * sub)
            return unpack_ids(torch.where(ids < n, pos, p * sub), p * sub)

    cand, ex = pipelined_expand_consume(g, sub_gather, c, args)
    if n_f is None:
        wire = None
    elif over:
        wire = _F32(comm_model.chunked_expand_1d_level_words(n, p, c))
    else:
        wire = comm_model.compressed_expand_1d_words(
            n_f, p, comm_model.codec_bits(sub), c) \
            if args.codec == "packed" \
            else comm_model.sparse_expand_1d_words(n_f, p)
    return cand, ex, wire


def topdown_level_1ds(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                      front: torch.Tensor, args: LevelArgs1D, lv: Dict
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One sparse-exchange top-down level: the "1d" level with the
    expand shipping frontier ids (bitmap on overflow).  The sieve mask
    ``(pi != -1) & ~front`` is everything found on EARLIER levels, so in
    the loop it leaves ``front`` whole.  Uninstrumented, ``lv["over"]``
    is the overflow predicate the loop read with the level's masses."""
    instr = args.instrument
    over = None if instr else lv["over"]
    visited = (pi != -1) & ~front
    if args.expand_chunks > 1:
        cand, ex, wire = _pipelined_topdown_1ds(g, front & ~visited, args,
                                                over)
    else:
        f_words, wire, _ = sparse_exchange_1d(
            front, args.cap_x, args.part, args.ops, visited=visited,
            codec=args.codec, over=over)
        cand, ex = args.ops.topdown(g, f_words, args)
    ctr = {}
    if instr:
        tr = lv.get("trace")
        if tr is not None:
            tr.count("host_reads")           # the send counts' read
        ctr = topdown_counters(lv, wire, ex)
        ctr["use_expand"] = comm_model.sparse_expand_1d_words(
            _F32(lv["n_f"]), args.part.p)
    pi, newly = update(pi, cand)
    return pi, newly, ctr


def bottomup_level_1ds(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                       front: torch.Tensor, args: LevelArgs1D, lv: Dict
                       ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Bottom-up levels exchange the dense bitmap: the heuristics enter
    bottom-up only on large frontiers, where the bitmap is the cheaper
    encoding.  The "1d" step, unchanged."""
    return bottomup_level_1d(g, pi, front, args, lv)
