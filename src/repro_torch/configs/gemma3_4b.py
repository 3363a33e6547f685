"""gemma3-4b [dense] — Gemma 3 4B text backbone.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; 5:1 local:global,
window 1024, qk-norm, local rope theta 10k / global 1M, sandwich norms,
GeGLU, 128k context [hf:google/gemma-3-*-pt; unverified].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    layer_pattern="LLLLLG",
    sliding_window=1024,
    mlp_kind="geglu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8,
    ).validate()
