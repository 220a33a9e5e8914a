"""Unified model configuration covering the whole assigned pool.

Port of ``repro/models/config.py``.  One ``ModelConfig`` describes every
architecture family (dense / MoE / SSM / hybrid / enc-dec / VLM-audio
backbones) through a per-layer ``layer_plan``;
``src/repro_torch/configs/<arch>.py`` instantiates the exact published
configs.  The fields are the reference's, so a config prints and compares
the same in both packages; ``pdtype`` and ``cdtype`` are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None         # default: d_model // n_heads
    # ---- attention options
    qk_norm: bool = False                  # per-head RMSNorm on q,k (qwen3)
    qkv_bias: bool = False                 # (qwen2)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # ---- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1                     # MoE on every k-th layer (llama4: 2)
    moe_d_ff: Optional[int] = None         # expert hidden dim (defaults d_ff)
    n_shared_experts: int = 0              # always-on experts (llama4 style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group: int = 4096                  # tokens per dispatch group (GShard)
    # ---- SSM (mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64                 # mamba2 (SSD) head size
    ssm_chunk: int = 256                   # SSD chunk length
    # ---- layer plan: per-layer block type; empty = all "attn" (or "mamba1"
    #      for family=="ssm").  Valid: attn, mamba1, mamba2, shared_attn.
    layer_plan: Tuple[str, ...] = ()
    shared_attn_every: int = 0             # zamba2: shared block cadence
    # ---- encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                    # stub frontend sequence length
    # ---- modality frontend stub: none | vision | audio
    frontend: str = "none"
    n_patches: int = 0                     # vlm: patch embeddings per sample
    # ---- numerics / policy
    scan_layers: bool = True               # False: unroll the layer loop
    #   (dry-run cost probes: XLA cost_analysis counts a scan body ONCE, so
    #    per-layer costs are measured on small unrolled models and
    #    extrapolated to full depth — see launch/dryrun.py)
    mlp_act: str = "swiglu"                # swiglu | gelu
    norm_type: str = "rmsnorm"             # rmsnorm | layernorm
    use_rope: bool = True                  # whisper uses learned abs-pos
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "selective"               # none | selective | full
    logit_softcap: float = 0.0
    grad_dtype: str = "float32"            # "bfloat16": custom-vjp xent emits
    #   bf16 cotangents so the whole backward (and its TP/FSDP collectives)
    #   runs at half width — §Perf hillclimb lever, off by default to keep
    #   the paper-faithful baseline
    shard_grads: bool = False              # constrain grads to the param
    #   shardings so the DP gradient reduction lowers as reduce-scatter
    #   (1× wire) instead of all-reduce (2× wire) — §Perf hillclimb lever
    gqa_grouped: bool = False              # GQA via grouped einsum instead
    #   of jnp.repeat(k/v): never materializes the expanded K/V, so the
    #   sharded KV cache is contracted in place — §Perf hillclimb lever
    ssd_bf16: bool = False                 # Mamba2 SSD intra-chunk tensors
    #   and matmuls in bf16 (f32 states/decays/accumulation — the reference
    #   Mamba2 training recipe) — §Perf hillclimb lever
    kv_cache_dtype: str = "compute"        # "int8": store the attention KV
    #   cache quantized per (token, head) with bf16 scales — halves the
    #   decode weight+cache read floor (§Perf cell B follow-up)
    # ---- serving
    max_cache_len: int = 0                 # set by the shape cell

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.layer_plan:
            default = {"ssm": "mamba1", "hybrid": "mamba2"}.get(self.family, "attn")
            plan = [default] * self.n_layers
            if self.shared_attn_every:
                for i in range(self.n_layers):
                    if (i + 1) % self.shared_attn_every == 0:
                        plan[i] = "mamba2+shared_attn"
            object.__setattr__(self, "layer_plan", tuple(plan))
        assert len(self.layer_plan) == self.n_layers

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def d_inner(self) -> int:      # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:  # mamba2 heads
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def uses_attention(self) -> bool:
        return any("attn" in p for p in self.layer_plan) or self.is_encoder_decoder

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) cells are runnable: no full-attention
        layer whose KV cache would be materialized at full seq length —
        SSM/hybrid qualify (hybrid's few shared-attn sites use a bounded
        sliding window at 500k; see transformer.py)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny sizes."""
        small = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            moe_d_ff=128 if self.n_experts else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            layer_plan=(),
            param_dtype="float32",
            compute_dtype="float32",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}
