"""autoint [arXiv:1810.11921; paper]: the JAX package's values."""
from repro_torch.configs.base import RecsysConfig, register

CONFIG = register(RecsysConfig(
    arch="autoint",
    n_sparse=39,
    embed_dim=16,
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
))
