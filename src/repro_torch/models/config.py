"""Unified model configuration (PyTorch port of ``repro.models.config``).

One frozen dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM /
audio; per-arch constructors live in ``repro_torch.configs.<id>``.  The
fields and derived properties are a copy of the JAX package's, so a config
built here describes the same model; only ``param_dtype`` answers with a
``torch.dtype``.  The port serves every branch the ten configs use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default: d_model // n_heads

    # ---- attention flavour ----
    attention: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False
    use_rope: bool = True          # whisper: absolute sinusoidal instead
    rope_theta: float = 1e4
    mrope: bool = False            # Qwen2-VL M-RoPE (3 position sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: Optional[int] = None   # decode-time window (long_500k)

    # ---- MLA (DeepSeek-V2) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0         # DeepSeek-V2: first layer(s) dense
    d_ff_dense: int = 0            # ff of those dense layers
    moe_group_size: int = 1024     # routing group for dispatch einsums
    moe_dispatch: str = "einsum"   # einsum (one-hot matmuls) | gather
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # ---- hybrid (Zamba2): one SHARED attention block every k SSM layers ----
    shared_attn_every: int = 0

    # ---- encoder-decoder (Whisper) ----
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 4             # decoder tokens = seq_len // dec_ratio

    # ---- modality frontend stubs ----
    frontend: Optional[str] = None  # None | audio | vision
    frontend_dim: int = 0           # dim of precomputed frame/patch embeds
    n_patches: int = 1024           # VLM: image patches prepended to text

    # ---- distribution / memory knobs (set by the launcher, not the arch) --
    remat: bool = True             # checkpoint each scanned layer
    act_seq_shard: bool = False    # sequence-parallel residual stream
    dp_axes: tuple = ("data",)     # mesh axes carrying the batch
    grad_accum: int = 1            # microbatch accumulation in train_step
    scan_unroll: int = 1           # unroll factor for layer scans
    cache_seq_shard: str = "auto"  # decode-cache seq axis: auto|none|model|
                                   # dp_model (auto = dp when batch==1)

    # ---- numerics / norm ----
    norm: str = "rmsnorm"          # rmsnorm | nonparametric_ln
    mlp: str = "swiglu"            # swiglu | gelu
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256  # pad embedding rows for sharding/MXU

    source: str = ""               # citation for the exact config

    # ------------------------------------------------------------ derived --
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def param_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} is not one of "
                             f"{sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, resolving hybrid/moe/dense patterns."""
        kinds = []
        for i in range(self.n_layers):
            if self.arch_type in ("ssm",):
                kinds.append("ssm")
            elif self.arch_type == "hybrid":
                kinds.append("ssm")   # shared attn handled separately
            elif self.is_moe and i >= self.first_k_dense:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds

    # ------------------------------------------------------------- reduced --
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        small_heads = max(1, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        small_kv = max(1, small_heads // min(ratio, small_heads))
        d_model = min(self.d_model, 256)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=d_model,
            n_heads=small_heads,
            n_kv_heads=small_kv,
            d_head=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            d_ff_dense=min(self.d_ff_dense, 512),
            vocab=512,
            vocab_pad_multiple=64,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            d_ff_expert=min(self.d_ff_expert, 128),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=32 if self.attention == "mla" else self.qk_nope_head_dim,
            qk_rope_head_dim=16 if self.attention == "mla" else self.qk_rope_head_dim,
            v_head_dim=32 if self.attention == "mla" else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            shared_attn_every=2 if self.shared_attn_every else 0,
            moe_group_size=64,
            mrope_sections=(8, 12, 12) if self.mrope else self.mrope_sections,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            n_patches=16 if self.frontend == "vision" else self.n_patches,
            dtype="float32",
        )
