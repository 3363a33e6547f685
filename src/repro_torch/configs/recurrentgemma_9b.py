"""recurrentgemma-9b [hybrid] — RecurrentGemma 9B (Griffin).

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000;
pattern: 2 RG-LRU recurrent blocks : 1 local attention (window 2048),
GeGLU, embed scaling [arXiv:2402.19427; unverified].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern="RRL",
    sliding_window=2048,
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    lru_width=4096,
    rope_theta=10000.0,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8, lru_width=64,
    ).validate()
