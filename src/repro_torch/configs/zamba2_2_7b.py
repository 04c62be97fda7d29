"""zamba2-2.7b [hybrid: Mamba2 + shared attention]  [arXiv:2411.15242]

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Mamba2 backbone with ONE shared attention+MLP block applied every 6
layers (the zamba2 shared-block design).  long_500k runs with a sliding
window on the shared attention block.
"""
from repro_torch.models.config import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
        attn_every=6,
        shared_attn=True,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-smoke",
        family="hybrid",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2),
        attn_every=2,
        shared_attn=True,
        source="arXiv:2411.15242",
    )
