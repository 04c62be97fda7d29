"""llama4-scout-17b-a16e [MoE]  [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 16 experts top-1,
early fusion.  40 q heads are padded to 48 for the tp=16 mesh (zero-init
extras — DESIGN.md hardware-adaptation notes).
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        n_experts=16,
        top_k=1,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-scout-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=4,
        top_k=1,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
