"""minitron-8b [dense GQA, pruned nemotron]  [arXiv:2407.14679]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
        source="arXiv:2407.14679",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="minitron-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        source="arXiv:2407.14679",
    )
