"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified].  The ViT frontend is a STUB: ``input_specs``
supplies precomputed patch embeddings prepended to the text sequence.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    layer_pattern="G",
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision_stub",
    n_frontend_tokens=64,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512, n_frontend_tokens=4,
    ).validate()
