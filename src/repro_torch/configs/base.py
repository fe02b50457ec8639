"""The configurations of the PyTorch port: the traversal's ``BFSConfig``,
the serving archs' ``LMConfig`` and ``RecsysConfig`` and the graph
networks' ``GNNConfig``, with their registry.

Each config carries the same fields and defaults as the JAX package's,
so one config object describes a session in either package.  The
registry holds the archs the port runs: ``autoint``, the five LM archs
(``smollm-135m``, ``stablelm-3b``, ``starcoder2-7b``, ``mixtral-8x22b``,
``qwen3-moe-30b-a3b`` and its ``qwen3-moe-r1`` to ``-r4`` variants), the
four GNN archs (``gin-tu``, ``gat-cora``, ``meshgraphnet``, ``mace``, each
with the four ``GNN_SHAPES``) and every ``bfs-rmat*`` arch
(``configs/bfs_rmat.py``): every arch of the JAX package.

The port runs every ``BFSConfig`` value the JAX package does: the three
decompositions, both storages in either ``local_mode``, every
``fold_mode`` ("reduce", "alltoall", "bitmap", "bitmap_pure"),
``compact_updates`` and ``use_edge_dst`` (bottom-up; the 1D strips read
``edge_dst`` in dense mode and ignore ``compact_updates``, as the JAX
package does), both frontier codecs, ``instrument`` True or False, and
any ``expand_chunks >= 1`` that divides the strip's packed words (and,
for "1ds", the bucket capacity; for "2d" any value > 1 runs the R/G
ring), and pod-batched searches (``BFSEngine.run_batch``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[LMShape, ...] = (
    LMShape("train_4k", 4096, 256, "train"),
    LMShape("prefill_32k", 32768, 32, "prefill"),
    LMShape("decode_32k", 32768, 128, "decode"),
    LMShape("long_500k", 524288, 1, "decode"),
)


@dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0            # sampled-training seed batch
    fanout: Tuple[int, ...] = ()    # neighbor-sampler fanouts
    batch_graphs: int = 0           # batched-small-graphs
    kind: str = "full"              # "full" | "sampled" | "batched"


GNN_SHAPES: Tuple[GNNShape, ...] = (
    GNNShape("full_graph_sm", 2708, 10556, d_feat=1433, kind="full"),
    GNNShape("minibatch_lg", 232965, 114615892, batch_nodes=1024,
             fanout=(15, 10), kind="sampled"),
    GNNShape("ogb_products", 2449029, 61859140, d_feat=100, kind="full"),
    GNNShape("molecule", 30, 64, batch_graphs=128, kind="batched"),
)


@dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    n_candidates: int = 0
    kind: str = "train"  # "train" | "serve" | "retrieval"


RECSYS_SHAPES: Tuple[RecsysShape, ...] = (
    RecsysShape("train_batch", 65536, kind="train"),
    RecsysShape("serve_p99", 512, kind="serve"),
    RecsysShape("serve_bulk", 262144, kind="serve"),
    RecsysShape("retrieval_cand", 1, n_candidates=1_000_000, kind="retrieval"),
)


@dataclass(frozen=True)
class BFSShape:
    name: str
    scale: int           # 2**scale vertices (Graph500 convention)
    degree: int = 16
    n_roots: int = 1     # batched roots (pod axis)
    kind: str = "bfs"


BFS_SHAPES: Tuple[BFSShape, ...] = (
    BFSShape("scale22", 22),
    BFSShape("scale26", 26),
    BFSShape("scale30", 30),
)


@dataclass(frozen=True)
class BFSConfig:
    arch: str = "bfs-rmat"
    # "2d" checkerboard | "1d" row strips | "1ds" sparse-exchange strips
    decomposition: str = "2d"
    storage: str = "csr"          # "csr" | "dcsc"
    # fold: "alltoall" (paper-faithful) | "reduce" (ring reduce-scatter)
    # | "bitmap"/"bitmap_pure" (compact fold)
    fold_mode: str = "reduce"
    alpha: float = 14.0           # top-down -> bottom-up switch (Beamer)
    beta: float = 24.0            # bottom-up -> top-down switch
    direction_optimizing: bool = True
    # True: counters and level_stats are computed every level
    instrument: bool = True
    use_edge_dst: bool = False    # bottom-up O(E) row read (no searchsorted)
    compact_updates: bool = False  # bottom-up compact (child,parent) sends
    frontier_codec: str = "packed"  # "1ds" bucket encoding
    expand_chunks: int = 1        # software-pipelined expand
    rmat_a: float = 0.57
    rmat_b: float = 0.19
    rmat_c: float = 0.19
    shapes: Tuple[BFSShape, ...] = BFS_SHAPES

    @property
    def kind(self) -> str:
        return "bfs"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class LMConfig:
    arch: str
    family: str            # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0
    rope_theta: float = 10000.0
    swa_window: Optional[int] = None      # sliding-window attention
    moe: Optional[MoEConfig] = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat_policy: str = "full"         # "none" | "full" | "dots"
    opt_state_dtype: str = "float32"
    loss_bf16: bool = False            # bf16 logits matmul, f32 accumulate
    fsdp: bool = False                 # shard dense weights over dp too
    shapes: Tuple[LMShape, ...] = LM_SHAPES

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def kind(self) -> str:
        return "lm"

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks)."""
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads * self.d_head) \
            + 2 * d * (self.n_kv_heads * self.d_head) \
            + (self.n_heads * self.d_head) * d
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        return L * (attn + ff + 2 * d) + self.vocab * d + d

    def n_active_params(self) -> int:
        """Parameters a token runs through: the MoE layers' top_k experts
        (and the router) in place of all of them."""
        d, L = self.d_model, self.n_layers
        attn = d * (self.n_heads * self.d_head) \
            + 2 * d * (self.n_kv_heads * self.d_head) \
            + (self.n_heads * self.d_head) * d
        if self.moe is not None:
            ff = self.moe.top_k * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.n_experts
        else:
            ff = 3 * d * self.d_ff
        return L * (attn + ff + 2 * d) + self.vocab * d + d


@dataclass(frozen=True)
class GNNConfig:
    arch: str
    model: str              # "gin" | "gat" | "meshgraphnet" | "mace"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"
    l_max: int = 0                   # MACE
    correlation_order: int = 0       # MACE
    n_rbf: int = 0                   # MACE
    eps_learnable: bool = False      # GIN
    mlp_layers: int = 2              # MeshGraphNet
    n_classes: int = 16
    dtype: str = "float32"
    shapes: Tuple[GNNShape, ...] = GNN_SHAPES

    @property
    def kind(self) -> str:
        return "gnn"


@dataclass(frozen=True)
class RecsysConfig:
    arch: str
    n_sparse: int
    embed_dim: int
    n_attn_layers: int
    n_heads: int
    d_attn: int
    vocab_sizes: Tuple[int, ...] = ()
    mlp_hidden: Tuple[int, ...] = (256, 128)
    dtype: str = "float32"
    shapes: Tuple[RecsysShape, ...] = RECSYS_SHAPES

    def __post_init__(self):
        if not self.vocab_sizes:
            # Criteo-like mix: a few huge tables, many medium/small ones.
            sizes = []
            for i in range(self.n_sparse):
                if i % 8 == 0:
                    sizes.append(2_000_000)
                elif i % 4 == 0:
                    sizes.append(200_000)
                elif i % 2 == 0:
                    sizes.append(20_000)
                else:
                    sizes.append(2_000)
            object.__setattr__(self, "vocab_sizes", tuple(sizes))

    @property
    def kind(self) -> str:
        return "recsys"

    def n_embed_rows(self) -> int:
        return sum(self.vocab_sizes)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Any] = {}


def register(cfg: Any) -> Any:
    if cfg.arch in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.arch}")
    _REGISTRY[cfg.arch] = cfg
    return cfg


def get_config(arch: str) -> Any:
    _ensure_loaded()
    if arch not in _REGISTRY:
        raise KeyError(f"arch {arch!r} is not ported yet (or unknown); "
                       f"the port runs {sorted(_REGISTRY)}")
    return _REGISTRY[arch]


def list_archs() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced(cfg: Any, **overrides: Any) -> Any:
    """A smoke-test-sized variant of a config (same family, tiny dims)."""
    return dataclasses.replace(cfg, **overrides)


def _ensure_loaded() -> None:
    # Importing the per-arch modules populates the registry (once: a
    # module body runs at its first import only).
    from repro_torch.configs import (  # noqa: F401
        autoint, bfs_rmat, gat_cora, gin_tu, mace, meshgraphnet,
        mixtral_8x22b, qwen3_moe_30b_a3b, smollm_135m, stablelm_3b,
        starcoder2_7b)
