"""Model / run configuration schema, copied from :mod:`repro.configs.base`
so the port imports nothing of the JAX package.

One :class:`ModelConfig` describes any architecture in the assigned pool:
dense decoder (GQA / MLA / sliding-window), MoE, SSM (Mamba2/SSD), hybrid
interleave (Jamba), encoder–decoder (Seamless backbone), and the VLM/audio
variants (backbone + embedding frontstub). ``layer_plan()`` compiles the
config into homogeneous layer groups whose parameters are stacked on a
leading layer axis; the port's model loops over that axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One homogeneous group of transformer blocks.

    mixer:  'attn' | 'mla' | 'swa' (sliding-window attn) | 'mamba'
    ff:     'mlp' | 'moe' | 'none'
    count:  how many consecutive layers share this spec (scanned together).
    """

    mixer: str
    ff: str
    count: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                       # citation for the config
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0                # 0 = dense FFN
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    first_dense_layers: int = 0       # leading dense layers before MoE starts
    moe_every: int = 1                # MoE in every k-th layer (jamba: 2)

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0              # 0 = full-rank q projection
    rope_head_dim: int = 64

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0                # N; 0 = no ssm layers
    ssm_expand: int = 2
    ssm_head_dim: int = 64            # P
    ssm_conv_width: int = 4
    ssm_chunk: int = 256              # SSD chunk length
    ssm_groups: int = 1               # G groups for B/C

    # --- hybrid (jamba) ---
    attn_period: int = 0              # 1 attention layer per `attn_period` layers
    attn_offset: int = 0              # which index in the period is attention

    # --- attention variants ---
    sliding_window: Optional[int] = None   # None = full causal
    attn_chunk: int = 1024                 # KV-chunk size for online-softmax attention
    kv_cache_dtype: str = "bfloat16"       # 'int8' = quantized serving cache (§Perf)

    # --- encoder-decoder ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 4096            # encoder memory length for decode shapes

    # --- modality frontend (stub: input_specs provide embeddings) ---
    frontend: str = "none"             # none | vision | audio
    frontend_seq: int = 0              # patches / frames prepended or encoded
    frontend_dim: int = 0              # embedding dim delivered by the stub

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    def mixer_for_layer(self, i: int) -> str:
        if self.ssm_state > 0 and self.attn_period == 0:
            return "mamba"                      # pure SSM
        if self.attn_period > 0:                # hybrid interleave
            if i % self.attn_period == self.attn_offset:
                return "swa" if self.sliding_window else "attn"
            return "mamba"
        if self.use_mla:
            return "mla"
        return "swa" if self.sliding_window else "attn"

    def ff_for_layer(self, i: int) -> str:
        if not self.is_moe:
            return "mlp" if self.d_ff > 0 else "none"
        if i < self.first_dense_layers:
            return "mlp"
        if (i - self.first_dense_layers) % self.moe_every == 0:
            return "moe"
        return "mlp"

    def layer_plan(self) -> list[BlockSpec]:
        """Compress the per-layer (mixer, ff) sequence into homogeneous,
        scannable groups. Repeating patterns (e.g. jamba's period-8
        interleave) produce a short list of groups cycled in order."""
        kinds = [(self.mixer_for_layer(i), self.ff_for_layer(i)) for i in range(self.n_layers)]
        groups: list[BlockSpec] = []
        for mixer, ff in kinds:
            if groups and (groups[-1].mixer, groups[-1].ff) == (mixer, ff):
                groups[-1] = dataclasses.replace(groups[-1], count=groups[-1].count + 1)
            else:
                groups.append(BlockSpec(mixer=mixer, ff=ff, count=1))
        return groups

    # ------------------------------------------------------------------
    def reduced(self, max_d_model: int = 256, n_layers: int = 2, max_experts: int = 4,
                max_vocab: int = 512) -> "ModelConfig":
        """CPU-smoke-test variant of the same family (2 layers, tiny dims)."""
        d_model = min(self.d_model, max_d_model)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        head_dim = max(d_model // n_heads, 8)
        changes = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 2 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, max_vocab),
            attn_chunk=64,
            param_dtype="float32",
            activation_dtype="float32",
        )
        if self.is_moe:
            changes.update(
                n_experts=min(self.n_experts, max_experts),
                top_k=min(self.top_k, 2),
                d_ff_expert=min(self.d_ff_expert, d_model),
                n_shared_experts=min(self.n_shared_experts, 1),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.use_mla:
            changes.update(kv_lora_rank=min(self.kv_lora_rank, 64),
                           q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
                           rope_head_dim=min(self.rope_head_dim, 16))
        if self.ssm_state > 0:
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=16,
                           ssm_chunk=32)
        if self.attn_period > 0:
            changes.update(attn_period=2, attn_offset=1, n_layers=max(n_layers, 2))
        if self.enc_dec:
            changes.update(n_enc_layers=2, enc_seq_len=64)
        if self.frontend != "none":
            changes.update(frontend_seq=min(self.frontend_seq, 16), frontend_dim=d_model)
        if self.sliding_window:
            changes.update(sliding_window=min(self.sliding_window, 32))
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the 4 assigned global input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
