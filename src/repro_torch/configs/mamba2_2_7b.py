"""mamba2-2.7b [ssm] — Mamba-2 2.7B (SSD, state-space duality).

64L d_model=2560, attention-free, ssm_state=128, expand 2 (d_inner 5120,
80 heads × head_dim 64), vocab 50280 (padded to 50304 for sharding)
[arXiv:2405.21060; unverified].
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,            # d_inner / head_dim
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    layer_pattern="M",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        vocab=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
                      chunk=32),
    ).validate()
