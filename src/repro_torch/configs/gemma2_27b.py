"""gemma2-27b [dense] — Gemma 2 27B.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; alternating
local(4096)/global attention, attn logit softcap 50, final softcap 30,
pre+post sandwich norms, GeGLU, query scale (d_model/n_heads)^-0.5
[arXiv:2408.00118; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    layer_pattern="LG",
    sliding_window=4096,
    mlp_kind="geglu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=(4608 // 32) ** -0.5,
    rope_theta=10000.0,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, sliding_window=16,
        query_scale=(128 // 4) ** -0.5,
    ).validate()
