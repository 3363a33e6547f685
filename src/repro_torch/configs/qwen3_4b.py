"""qwen3-4b [dense] — Qwen3 4B.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936; qk-norm, head_dim
128 (decoupled from d_model) [hf:Qwen/Qwen3-*; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    layer_pattern="G",
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
    ).validate()
