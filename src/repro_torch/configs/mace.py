"""mace — higher-order equivariant message passing [arXiv:2206.07697;
paper]: the JAX package's values."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    arch="mace",
    model="mace",
    n_layers=2,
    d_hidden=128,
    l_max=2,
    correlation_order=3,
    n_rbf=8,
    aggregator="sum",
))
