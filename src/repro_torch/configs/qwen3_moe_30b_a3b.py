"""qwen3-moe-30b-a3b, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]: the
JAX package's values, and its four variants: r1 remat "dots", r2
``capacity_factor`` 1.0, r3 bf16 optimizer state, r4 ``loss_bf16``."""
import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig, register

CONFIG = register(LMConfig(
    arch="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # d_ff is per-expert for this config
    vocab=151936,
    d_head=128,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
))
CONFIG_R1 = register(dataclasses.replace(CONFIG, arch="qwen3-moe-r1",
                                         remat_policy="dots"))
CONFIG_R2 = register(dataclasses.replace(
    CONFIG_R1, arch="qwen3-moe-r2",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  capacity_factor=1.0)))
CONFIG_R3 = register(dataclasses.replace(CONFIG_R2, arch="qwen3-moe-r3",
                                         opt_state_dtype="bfloat16"))
CONFIG_R4 = register(dataclasses.replace(CONFIG_R3, arch="qwen3-moe-r4",
                                         loss_bf16=True))
