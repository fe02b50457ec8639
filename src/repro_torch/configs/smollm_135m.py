"""smollm-135m, llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]: the
JAX package's values."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    arch="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
))
