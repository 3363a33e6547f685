"""seamless-m4t-medium [audio] — SeamlessM4T-medium text/speech backbone.

Encoder–decoder: 12L encoder + 12L decoder, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 (padded to 256256); LayerNorm, sinusoidal positions
[arXiv:2308.11596; hf].  The speech frontend is a STUB: ``input_specs``
supplies precomputed audio frame embeddings to the encoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder depth
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    layer_pattern="G",
    mlp_kind="geglu",
    norm_kind="layernorm",
    pos_kind="abs_sinusoidal",
    tie_embeddings=True,
    frontend="audio_stub",
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256,
    ).validate()
