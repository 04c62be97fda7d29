"""minicpm3-4b [dense, MLA]  [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H (kv=40 i.e. MHA within MLA) d_ff=6400 vocab=73448.
Real Multi-head Latent Attention: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v=64 (per the MiniCPM3 card).  40 heads pad to 48 for tp=16.
"""
from repro_torch.models.config import MLAConfig, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab=73448,
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        source="hf:openbmb/MiniCPM3-4B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="minicpm3-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        mla=MLAConfig(
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        ),
        source="hf:openbmb/MiniCPM3-4B",
    )
