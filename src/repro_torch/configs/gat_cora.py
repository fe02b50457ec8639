"""gat-cora [arXiv:1710.10903; paper]: the JAX package's values."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    arch="gat-cora",
    model="gat",
    n_layers=2,
    d_hidden=8,
    n_heads=8,
    aggregator="attn",
    n_classes=7,
))
