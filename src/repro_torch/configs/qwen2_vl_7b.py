"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution; ViT frontend STUBBED
(input_specs provides patch embeddings).  [arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        arch_type="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_head=128,
        d_ff=18944,
        vocab=152064,
        mrope=True,
        mrope_sections=(16, 24, 24),   # halves of head_dim 128
        rope_theta=1e6,
        frontend="vision",
        frontend_dim=1280,             # ViT output width (stub)
        n_patches=1024,                # 32x32 patch grid prepended
        source="arXiv:2409.12191 (Qwen2-VL), 7B variant",
    )
