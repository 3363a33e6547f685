"""deepseek-v3-671b [moe] — DeepSeek-V3.

61L d_model=7168 128H MLA d_ff=2048 (per routed expert) vocab=129280,
MoE: 1 shared + 256 routed top-8, sigmoid router; MLA with kv_lora 512,
q_lora 1536, rope head 64; first 3 layers dense (d_ff 18432); MTP depth 1
[arXiv:2412.19437; hf].
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab=129280,
    layer_pattern="G",
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        n_routed=256, n_shared=1, top_k=8, d_expert=2048, d_shared=2048,
        router="sigmoid", norm_topk=True, aux_loss_coef=0.0001,
        n_dense_layers=3, d_ff_dense=18432,
        impl="a2a",  # 256 experts == 16×16 EP group → explicit all-to-all
    ),
    mtp_depth=1,
).validate()


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=64, vocab=256,
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32),
        moe=dataclasses.replace(CONFIG.moe, n_routed=8, top_k=2, d_expert=64,
                                d_shared=64, n_dense_layers=1, d_ff_dense=128),
        mtp_depth=1,
    ).validate()
