"""codeqwen1.5-7b [dense] — CodeQwen1.5-7B (qwen1.5 arch).

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    layer_pattern="G",
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512,
    ).validate()
