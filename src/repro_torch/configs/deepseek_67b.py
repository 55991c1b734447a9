"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama architecture.  [arXiv:2401.02954]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        arch_type="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=102400,
        rope_theta=1e4,
        source="arXiv:2401.02954 (DeepSeek LLM), 67B variant",
    )
