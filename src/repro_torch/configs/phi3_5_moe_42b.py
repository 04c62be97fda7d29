"""phi3.5-moe-42b-a6.6b [MoE 16e top-2]  [hf:microsoft/Phi-3.5-MoE-instruct]

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, 16 experts top-2.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        top_k=2,
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        n_experts=4,
        top_k=2,
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
