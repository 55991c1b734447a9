"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=1,                  # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        attention="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,            # 80 SSD heads = 5120 / 64
        source="arXiv:2405.21060 (Mamba2), 2.7B variant",
    )
