"""gin-tu [arXiv:1810.00826; paper]: the JAX package's values."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    arch="gin-tu",
    model="gin",
    n_layers=5,
    d_hidden=64,
    aggregator="sum",
    eps_learnable=True,
))
