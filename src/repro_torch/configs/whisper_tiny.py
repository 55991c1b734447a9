"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.

Encoder-decoder with conv/mel frontend STUBBED (input_specs provides frame
embeddings).  [arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        arch_type="audio",
        n_layers=4,                 # decoder layers
        n_enc_layers=4,             # encoder layers
        encoder_decoder=True,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,               # MHA
        d_head=64,
        d_ff=1536,
        vocab=51865,
        mlp="gelu",
        use_rope=False,             # absolute sinusoidal positions
        frontend="audio",
        frontend_dim=80,            # mel bins, stub embedding width
        dec_ratio=4,                # decoder tokens = seq_len // 4
        source="arXiv:2212.04356 (Whisper), tiny variant",
    )
