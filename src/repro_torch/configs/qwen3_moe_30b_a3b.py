"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=768,                   # per-expert intermediate
        d_ff_expert=768,
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
        n_experts=128,
        moe_top_k=8,
        n_shared_experts=0,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
