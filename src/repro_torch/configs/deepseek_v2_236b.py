"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 (per expert)
vocab=102400, MoE 160 routed top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,             # MLA: per-head keys from shared latent
        d_ff=1536,
        d_ff_expert=1536,
        vocab=102400,
        attention="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        moe_top_k=6,
        n_shared_experts=2,
        first_k_dense=1,            # first layer is a dense FFN layer
        d_ff_dense=12288,
        source="arXiv:2405.04434 (DeepSeek-V2)",
    )
