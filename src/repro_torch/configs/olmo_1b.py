"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm.  [arXiv:2402.00838]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50304,
        norm="nonparametric_ln",
        source="arXiv:2402.00838 (OLMo), 1B variant",
    )
