"""starcoder2-7b, GQA, RoPE [arXiv:2402.19173; hf]: the JAX package's
values.  36 query heads on 4 kv heads (a GQA group of 9).  ``fsdp``
shards the dense weights over the data axes of a real mesh in the JAX
package; on one card it changes nothing."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    arch="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    fsdp=True,
))
