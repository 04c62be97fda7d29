"""mamba2-780m [SSM / SSD]  [arXiv:2405.21060]

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128.  Pure SSD
(state-space duality) stack; head_dim=64, expand=2 -> d_inner=3072,
48 SSD heads.
"""
from repro_torch.models.config import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
        source="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2),
        source="arXiv:2405.21060",
    )
