"""internlm2-20b [dense GQA]  [arXiv:2403.17297]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92544,
        source="arXiv:2403.17297",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        source="arXiv:2403.17297",
    )
