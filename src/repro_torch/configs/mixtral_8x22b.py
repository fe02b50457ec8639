"""mixtral-8x22b, 8 experts top-2, sliding window [arXiv:2401.04088; hf]:
the JAX package's values.  Its bf16 parameters (280.9 GB) exceed one
card, so it runs on the card at reduced dims or cut in depth."""
from repro_torch.configs.base import LMConfig, MoEConfig, register

CONFIG = register(LMConfig(
    arch="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
))
