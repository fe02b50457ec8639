"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified]: the JAX
package's values.  32 heads of d_head 80 (MHA), which kernels 9 and 9b
run zero-padded to 128."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    arch="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
))
