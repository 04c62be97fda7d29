"""internvl2-26b [VLM: InternViT + InternLM2]  [arXiv:2404.16821]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The assigned
backbone is the language decoder; the InternViT vision encoder +
projector frontend is STUBBED — input_specs() provides 256 projected
patch embeddings (B, 256, d_model) prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92553,
        n_prefix=256,
        source="arXiv:2404.16821",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        n_prefix=16,
        source="arXiv:2404.16821",
    )
