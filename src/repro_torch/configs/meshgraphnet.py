"""meshgraphnet [arXiv:2010.03409; unverified]: the JAX package's values."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    arch="meshgraphnet",
    model="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    aggregator="sum",
    mlp_layers=2,
))
