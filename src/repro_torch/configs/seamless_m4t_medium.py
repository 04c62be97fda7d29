"""seamless-m4t-medium [audio enc-dec]  [arXiv:2308.11596]

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  Interpreted as a
12-layer speech encoder + 12-layer text decoder (the assigned backbone);
the mel-spectrogram + conv feature extractor frontend is STUBBED —
input_specs() provides precomputed frame embeddings (B, S_enc, d_model).
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="seamless-m4t-medium",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        n_prefix=1024,  # encoder frame positions fed by the frontend stub
        source="arXiv:2308.11596",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="seamless-m4t-medium-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        n_prefix=16,
        source="arXiv:2308.11596",
    )
