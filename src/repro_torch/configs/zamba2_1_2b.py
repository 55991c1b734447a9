"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 blocks + ONE shared attention block
(reused every 6 layers, the Zamba trick).  [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        arch_type="hybrid",
        n_layers=38,                # mamba2 layers
        d_model=2048,
        n_heads=32,                 # shared attention block heads
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,                  # shared block MLP
        vocab=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        shared_attn_every=6,
        source="arXiv:2411.15242 (Zamba2), 1.2B variant",
    )
