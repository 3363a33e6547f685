"""qwen2-moe-a2.7b [moe] — Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=151936,
MoE: 4 shared + 60 routed, top-4  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
Shared-expert hidden width 5632 (= 4×1408, the fused shared expert).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    layer_pattern="G",
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_routed=60, n_shared=1, top_k=4, d_expert=1408, d_shared=5632,
        router="softmax", norm_topk=False, aux_loss_coef=0.001,
    ),
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256,
        moe=dataclasses.replace(CONFIG.moe, n_routed=8, top_k=2, d_expert=96,
                                d_shared=128),
    ).validate()
