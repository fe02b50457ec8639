"""The paper's §6 communication model, the parts the port reads: the
whole-search 2D forms of Table 1 and Eq. 2, wire words per level of the
1D dense, chunked, sparse and packed frontier exchanges and of the 2D
bitmap fold, the packed codec's widths, the 1ds bucket planning, the
born-sharded build's routing volumes and bucket capacities, and the
Graph500 validator's collective budget, and ``AlphaBeta``'s
latency/bandwidth costs on the H100's NVLink.

Counts are in the paper's 64-bit words.  These are the closed forms of
the JAX package's ``core/comm_model.py`` (which imports no JAX but is
not imported here: the port keeps its own copy).  Each works on host
ints and floats; the per-frontier forms also take a numpy float32
count and then round every step in float32, in the reference's
operation order, as its in-program counters do.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.launch import roofline


def topdown_words(n: int, m: int, pr: int, pc: int) -> float:
    """w_t ~= 4m + n*pr  (undirected: each edge examined from both sides,
    2 words per edge endpoint pair; expand replicates n along columns)."""
    return 4.0 * m + float(n) * pr


def bottomup_words(n: int, pr: int, pc: int, s_b: float = 4.0) -> float:
    """w_b ~= n * (s_b*(pr+pc+1)/64 + 2)   (Table 1 total)."""
    return n * (s_b * (pr + pc + 1) / 64.0 + 2.0)


def ratio_eq2(k: float, pc: int, s_b: float = 4.0) -> float:
    """Eq. (2), square grid pr=pc: (pc + 4k) / (s_b(2pc+1)/64 + 2)."""
    return (pc + 4.0 * k) / (s_b * (2.0 * pc + 1.0) / 64.0 + 2.0)


def _float(x):
    """The float type a closed form computes in: a numpy scalar's own,
    else Python's."""
    return x.dtype.type if hasattr(x, "dtype") else float


def expand_1d_level_words(n, p):
    """Dense 1D expand of one level: one n-bit bitmap, every chunk
    replicated to the other p-1 processors: (p-1) * n/64 words."""
    return (p - 1) * (n / 64.0)


def chunked_expand_1d_level_words(n, p, n_chunks: int):
    """The chunked (pipelined) dense expand: ``n_chunks`` sub-chunk
    gathers that together move exactly the one bitmap, so the same
    words as ``expand_1d_level_words``.  ``n_chunks`` must divide the
    per-strip bitmap extent (chunk/32 words)."""
    if n_chunks < 1:
        raise ValueError(f"expand_chunks must be >= 1, got {n_chunks}")
    chunk_words = (n // max(p, 1)) // 32
    if chunk_words % n_chunks:
        raise ValueError(
            f"expand_chunks={n_chunks} does not divide the per-strip "
            f"bitmap extent ({chunk_words} packed words)")
    return expand_1d_level_words(n, p)


def expand_1d_words(n: int, p: int, n_levels: int) -> float:
    """A whole search of the dense "1d" expand: ``n_levels`` bitmaps."""
    return float(n_levels) * expand_1d_level_words(n, p)


def sparse_expand_1d_words(n_f, p):
    """Sparse owner-directed expand ("1ds", raw ids): each of the
    ``n_f`` frontier ids goes to the other p-1 processors, 1 id = 1
    word."""
    return n_f * _float(n_f)(p - 1.0)


def codec_bits(chunk: int) -> int:
    """Offset width of the packed codec: ceil(log2(chunk)) bits."""
    return max(1, int(chunk - 1).bit_length())


def codec_packed_words(cap_x: int, bits: int) -> int:
    """u32 words holding ``cap_x`` offsets packed at ``bits`` each."""
    return -((-cap_x * bits) // 32)


def codec_bucket_words(cap_x: int, bits: int) -> int:
    """u32 words of one encoded bucket: the count word + the payload."""
    return 1 + codec_packed_words(cap_x, bits)


def compressed_expand_1d_words(n_f, p, bits: int, n_chunks: int = 1):
    """Packed sparse expand of one level: each of the ``n_f`` ids costs
    ``bits`` bits, plus one u32 count word per bucket from each of the
    p owners (``n_chunks`` buckets each when pipelined, at the narrower
    ``codec_bits(chunk/n_chunks)`` the caller passes), all replicated
    to the other p-1 processors."""
    f = _float(n_f)
    return f(p - 1.0) * (n_f * f(bits) + f(32.0 * p * n_chunks)) / f(64.0)


def compressed_expand_padded_words(cap_x: int, p: int, bits: int) -> float:
    """Physical buffer volume of the packed static-shape exchange, in
    64-bit words: p owners x (p-1) peers x the whole encoded bucket
    (``codec_bucket_words`` u32 words, half a paper word each), sentinel
    slots included."""
    return float(p) * (p - 1.0) * codec_bucket_words(cap_x, bits) / 2.0


def hybrid_expand_1d_level_words(n_f_local_max: float, n_f: float, n: int,
                                 p: int, cap_x: int,
                                 bits: int = 0) -> float:
    """One "1ds" level's wire: sparse ids while every processor's bucket
    fits ``cap_x``, else the dense bitmap for the level.  ``bits > 0``
    prices the packed codec on the sparse branch; 0 keeps raw ids at one
    word each."""
    if n_f_local_max > cap_x:
        return expand_1d_level_words(n, p)
    if bits > 0:
        return compressed_expand_1d_words(n_f, p, bits)
    return sparse_expand_1d_words(n_f, p)


def sparse_expand_padded_words(cap_x: int, p) -> float:
    """Physical buffer volume of the static-shape sparse exchange: the
    tiled allgather moves the whole ``cap_x``-slot bucket, sentinels
    included, from each of the p owners to its p-1 peers, in the id
    units of ``sparse_expand_1d_words``."""
    return float(p) * (p - 1.0) * cap_x


def plan_cap_x(n: int, p: int, m: int, align: int = 32,
               bits: int = 64) -> int:
    """The "1ds" per-processor bucket capacity: the sparse exchange
    beats the bitmap while the global frontier is under n/bits ids, so
    n/(bits*p) per processor, with the expected level-1 load (2m/n)/p as
    headroom and ``align`` as the floor; never above the chunk.  ``m``
    (the real edge count) is required."""
    if m <= 0:
        raise ValueError(
            f"plan_cap_x needs the real edge count to size the level-1 "
            f"headroom (got m={m}); pass graph.m")
    chunk = max(n // max(p, 1), 1)
    d_avg = int(2.0 * m / n) if n else 0
    cap = max(n // (max(bits, 1) * max(p, 1)), d_avg // max(p, 1) + 1,
              align)
    cap = ((cap + align - 1) // align) * align
    return min(cap, ((chunk + align - 1) // align) * align)


def fold_bitmap_level_words(nr: int, pc: int, cap_w: int) -> float:
    """Per-level, per-processor wire of the 2D bitmap fold
    (``steps._fold_bitmap``): two bitmap all_to_all rounds (candidate
    presence out, winner bits back: nr bits = nr/64 words each) and two
    id all_to_alls (the winners' parent ids and their local offsets,
    pc*cap_w ids each, 1 id = 1 word):

        2 * nr/64  +  2 * pc * cap_w

    The live ``wire_fold`` counter multiplies it by p."""
    return 2.0 * nr / 64.0 + 2.0 * pc * cap_w


def topdown_1d_words(m: int, p: int) -> float:
    """Classic sparse 1D top-down volume: a (p-1)/p share of the 2m
    directed endpoints is remote and ships once as an id."""
    return 2.0 * m * (p - 1) / p

def strip_csr_pointer_words(n: int, p: int) -> float:
    """§5.1 storage charge of an uncompressed strip CSC: n+1 column
    pointers on every processor, O(n*p) words in all."""
    return float(p) * (n + 1)


def strip_dcsc_pointer_words(nzc_total: float, p: int) -> float:
    """The strip DCSC's pointers: (jc, cp) pairs over the non-empty
    columns only, 2*nzc + 2 words a strip; ``nzc_total`` is the sum of
    the strips' non-empty column counts."""
    return 2.0 * float(nzc_total) + 2.0 * p


def rmat_strip_skew(p: int, a: float = 0.57, b: float = 0.19) -> float:
    """Expected share of R-MAT edge endpoints in the heaviest 1/p vertex
    range (the low-id strip): ~(a+b)**log2(p).  Strip capacities are
    padded to that strip's nnz, so this sets the padded memory."""
    if p <= 1:
        return 1.0
    return float((a + b) ** math.log2(p))


def build_route_1d_words(m_input: int, p: int) -> float:
    """Expected owner-routing volume of the 1D distributed build: every
    generated edge is emitted in both directions (2*m_input records, one
    64-bit word each) and a uniformly partitioned destination leaves a
    (p-1)/p share remote.  One all_to_all round."""
    return 2.0 * m_input * (p - 1) / p


def build_route_2d_words(m_input: int, pr: int, pc: int) -> float:
    """Expected two-hop routing volume of the 2D build: hop 1 to the
    block column owner along the pc-sized axis, hop 2 to the block row
    owner along the pr-sized axis; the 1D record count, charged a hop."""
    return 2.0 * m_input * ((pc - 1) / pc + (pr - 1) / pr)


def build_route_padded_words(p: int, cap_route: int) -> float:
    """The volume one capped all_to_all round of the JAX package ships:
    every device its full (p, cap_route) buckets minus the diagonal,
    whatever their fill (the static-shape tax; the port routes the
    records unpadded and reports this figure beside its own count)."""
    return float(p) * (p - 1) * cap_route


def plan_cap_route(records: int, p: int, a: float = 0.57, b: float = 0.19,
                   slack: float = 1.5, pad: int = 32) -> int:
    """Per-destination bucket capacity of one routing round: ``records``
    generated records over p buckets whose heaviest takes
    ~rmat_strip_skew(p), inflated by ``slack``, rounded up to ``pad``.
    A bucket past it raises (``graph/dist_build.py``); the build never
    drops an edge quietly.  The float arithmetic is the JAX package's,
    step for step, because the capacity decides whether a build
    overflows."""
    frac = max(rmat_strip_skew(p, a, b), 1.0 / max(p, 1))
    cap = int(slack * frac * records) + pad
    return ((cap + pad - 1) // pad) * pad


@dataclass(frozen=True)
class AlphaBeta:
    """Machine terms of the latency/bandwidth model, for relative
    predictions.  ``beta_n`` is the H100's NVLink 4 rate each way
    (``roofline.LINK_BW``); ``alpha_n`` keeps the JAX package's 1 us, a
    stand-in that no card measured."""
    alpha_n: float = 1e-6                  # network latency (s)
    beta_n: float = 1.0 / roofline.LINK_BW  # s per byte per link

    def expand_cost(self, n: int, pr: int, pc: int, word_bytes: int = 8) -> float:
        return pr * self.alpha_n + (n / pc) * word_bytes * self.beta_n

    def fold_cost(self, m: int, pr: int, pc: int, word_bytes: int = 8) -> float:
        p = pr * pc
        return pc * self.alpha_n + (m / p) * word_bytes * self.beta_n

    def bottomup_level_cost(self, n: int, pr: int, pc: int) -> float:
        # pc sub-steps of rotation + updates, bitmap-compressed
        rotate = pc * (self.alpha_n + (n / (pr * pc) / 8) * self.beta_n)
        gather = pr * self.alpha_n + (n / pc / 8) * self.beta_n
        updates = pc * self.alpha_n + (n / (pr * pc)) * 8 * self.beta_n
        return rotate + gather + updates


def level_collective_budget(decomposition: str, mode: str, pc: int = 1,
                            fold_mode: str = "alltoall",
                            compact_updates: bool = False,
                            codec: str = "none",
                            expand_chunks: int = 1) -> int:
    """Per-level collective budget of the ``instrument=False`` level
    bodies, counted as the JAX package counts its lowered program: both
    branches of a ``lax.cond`` count.  The level loop adds one fused
    reduction a level on top (and, batched over pods, the lockstep
    pmax).

      2d top-down : transpose permute + allgather + the fold (alltoall:
                    1; ring reduce: pc-1 permutes; bitmap_pure: 4
                    all_to_alls, two bitmap rounds and the winners'
                    values and offsets; "bitmap": those, the overflow
                    pmax and the dense fallback's all_to_all)
      2d bottom-up: transpose permute + allgather + the pc-1 rotation
                    permutes + one update all_to_all; compact updates
                    add the overflow pmax and the dense fallback's
                    all_to_all.  ``expand_chunks > 1`` runs the R/G
                    split ring: 2(pc-1) permutes.
      1d          : one bitmap allgather a level, C at expand_chunks C.
      1ds top-down: the sparse/dense allgather pair (2C in the text, C
                    execute); the packed codec changes bytes, not ops.
      1d/1ds bu   : the one dense bitmap allgather."""
    if codec not in ("none", "packed"):
        raise ValueError(f"no collective budget modeled for "
                         f"codec={codec!r}")
    if expand_chunks < 1:
        raise ValueError(f"no collective budget modeled for "
                         f"expand_chunks={expand_chunks!r}")
    if decomposition == "2d":
        if mode == "td":
            folds = {"alltoall": 1, "reduce": max(pc - 1, 1),
                     "bitmap_pure": 4, "bitmap": 6}
            if fold_mode not in folds:
                raise ValueError(f"no collective budget modeled for "
                                 f"fold_mode={fold_mode!r}")
            return 2 + folds[fold_mode]
        if mode == "bu":
            rot = (2 if expand_chunks > 1 else 1) * (pc - 1)
            return rot + 3 + (2 if compact_updates else 0)
    if decomposition in ("1d", "1ds") and mode in ("td", "bu"):
        if decomposition == "1ds" and mode == "td":
            return 2 * expand_chunks
        if decomposition == "1d" and mode == "td":
            return expand_chunks
        return 1
    raise ValueError(f"no collective budget modeled for "
                     f"decomposition={decomposition!r} mode={mode!r}")


def level_budgets_for(decomposition: str, *, pc: int, p: int,
                      fold_mode: str = "alltoall",
                      compact_updates: bool = False,
                      frontier_codec: str = "none",
                      expand_chunks: int = 1) -> Dict[str, int]:
    """Both level budgets of one schedule case: the keywords are the
    BFSConfig fields an entry lists in ``schedule_dims``.  The grid the
    budget scales with is ``pc`` on the 2D checkerboard and the strip
    count ``p`` on the strips."""
    grid = pc if decomposition == "2d" else p
    return {mode: level_collective_budget(
        decomposition, mode, grid, fold_mode=fold_mode,
        compact_updates=compact_updates, codec=frontier_codec,
        expand_chunks=expand_chunks) for mode in ("td", "bu")}


def validate_collective_budget(decomposition: str) -> Dict[str, int]:
    """Whole-program collective budget of the sharded parent-tree
    validator (``core/validate.py``), per decomposition: one tiled
    all_gather per mesh axis to replicate the candidate parents (1 for
    the strip entries, 2 for "2d"), one psum to OR the per-shard
    tree-edge marks and one psum for the (6,) verdict.  Everything else
    (pointer doubling, the per-slot level and reach checks) is
    shard-local.  On the simulated mesh each gather is the parents read
    in global order and each psum a sum over the shard loop."""
    if decomposition == "2d":
        gathers = 2
    elif decomposition in ("1d", "1ds"):
        gathers = 1
    else:
        raise ValueError(
            f"no validator collective budget for {decomposition!r}; "
            "extend validate_collective_budget alongside the new "
            "decomposition's local_edges hook")
    return {"all-gather": gathers, "all-reduce": 2,
            "total": gathers + 2}
