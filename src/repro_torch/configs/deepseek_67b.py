"""deepseek-67b [dense GQA, llama-arch]  [arXiv:2401.02954]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.  The largest
assigned config — FSDP over "data" is what makes it fit 16 GB/chip.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=102400,
        source="arXiv:2401.02954",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        source="arXiv:2401.02954",
    )
