"""Model configuration system for the assigned architecture pool.

One frozen dataclass tree describes every family: dense / GQA transformers
(with sliding-window, soft-capping, qk-norm variants), MLA (DeepSeek-V3),
MoE (shared + routed top-k), Mamba2 SSD, RG-LRU hybrids (RecurrentGemma),
encoder–decoder (Seamless backbone), and modality-stub frontends (ViT/audio
embeddings supplied by ``input_specs``).

``layer_pattern`` is a repeating string over sub-layer kinds:
  G = global attention, L = local (sliding-window) attention,
  R = RG-LRU recurrent block, M = Mamba2 SSD block.
``n_layers`` need not be a multiple of ``len(layer_pattern)``; the trailing
remainder is instantiated unrolled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 8
    n_shared: int = 0
    top_k: int = 2
    d_expert: int = 1408          # routed expert hidden width
    d_shared: int = 0             # shared expert hidden width (0 = d_expert)
    router: str = "softmax"       # "softmax" | "sigmoid" (deepseek-v3)
    norm_topk: bool = True
    aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25
    n_dense_layers: int = 0       # leading dense layers (deepseek: 3)
    d_ff_dense: int = 0           # width of those dense layers
    impl: str = "sharded"         # dispatch: "sharded" (per-data-shard
                                  # capacity buffers, EP-friendly) |
                                  # "global" (naive global buffer baseline)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    layer_pattern: str = "G"
    mlp_kind: str = "swiglu"      # swiglu | geglu
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_norms: bool = False      # gemma2/3 sandwich norms
    tie_embeddings: bool = True
    embed_scale: bool = False     # multiply embeddings by sqrt(d_model)
    pos_kind: str = "rope"        # rope | abs_sinusoidal
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None  # gemma3: local layers use 10k
    sliding_window: Optional[int] = None      # for 'L' layers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    query_scale: Optional[float] = None       # default head_dim**-0.5
    attn_kind: str = "gqa"        # gqa | mla
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp_depth: int = 0            # deepseek multi-token-prediction heads
    # encoder–decoder
    enc_layers: int = 0           # >0 => enc-dec; n_layers is decoder depth
    # modality frontend stubs
    frontend: Optional[str] = None            # "vision_stub" | "audio_stub"
    n_frontend_tokens: int = 0                # prepended embedding tokens
    # recurrent (RG-LRU) width
    lru_width: int = 0
    # vocab padding for clean sharding
    pad_vocab_multiple: int = 128
    # training numerics
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return set(self.layer_pattern) <= {"M"}

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM / hybrid /
        local-attention layers bound the per-layer KV to the window; global
        layers handled by sequence-parallel decode)."""
        return ("M" in self.layer_pattern or "R" in self.layer_pattern
                or "L" in self.layer_pattern)

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def serving_gate_report(self) -> Optional[str]:
        """Why this config cannot serve chunked/paged — or None if it can.

        The continuous engine covers both layer-state families (see
        :mod:`repro.core.layer_state`): ring-KV layers with a retention
        rule — 'G' layers retire behind the clustered coverage frontier
        (FrontierRetention) or a block quota (QuotaRetention), 'L'
        layers behind their own sliding window (WindowRetention) — and
        recurrent-state layers ('M' Mamba2 SSD, 'R' RG-LRU) whose
        fixed-size state is advanced in the mixed launch and never
        retires (RecurrentRetention).  What remains ungated: MLA latent
        caches, encoder–decoder cross attention, modality frontends,
        'L' without a window, and unknown kinds.

        The report enumerates **every** unsupported (layer, kind) pair
        — not just the first blocking layer — so a mixed config's
        diagnostics name all the gaps at once and the validation error
        says *what* to fix, not just 'unsupported'.
        """
        problems = []
        if self.is_encdec:
            problems.append("encoder-decoder cross-attention "
                            f"(enc_layers={self.enc_layers}) has no "
                            "retention policy")
        if self.attn_kind == "mla":
            problems.append("attn_kind 'mla' caches latent KV, which no "
                            "retention policy covers")
        if self.n_frontend_tokens:
            problems.append(f"modality frontend ({self.n_frontend_tokens} "
                            "prepended tokens) breaks position-0 admission")
        kind_names = {"G": "global attention", "L": "local attention",
                      "R": "RG-LRU recurrence", "M": "Mamba2 SSD"}
        for i in range(self.n_layers):
            kind = self.pattern_for_layer(i)
            if kind in ("G", "M", "R"):
                continue
            if kind == "L" and self.sliding_window:
                continue
            what = kind_names.get(kind, f"unknown kind '{kind}'")
            why = (" without sliding_window" if kind == "L"
                   else " has no layer-state family")
            problems.append(f"layer {i}: {what}{why}")
        if not problems:
            return None
        return (f"model '{self.name}' needs state handling the engine "
                "lacks: " + "; ".join(problems) +
                " — global attention ('G'), sliding-window local layers "
                "('L'), and recurrent-state layers ('M' Mamba2 SSD, 'R' "
                "RG-LRU) serve chunked/paged")

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0 or self.attn_kind == "mla"
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.n_routed
        if "M" in self.layer_pattern:
            assert self.ssm is not None
        if "R" in self.layer_pattern:
            assert self.lru_width > 0
        if self.attn_kind == "mla":
            assert self.mla is not None
        return self


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (architecture × input-shape) cell."""
    shape_name: str               # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    step: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
