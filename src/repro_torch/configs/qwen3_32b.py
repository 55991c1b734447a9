"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        arch_type="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=25600,
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B (family card, 32B variant)",
    )
