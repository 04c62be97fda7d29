"""Model configuration covering all assigned architecture families.

One dataclass describes dense GQA, MLA, MoE, SSM (Mamba2/SSD), hybrid
(Mamba2+shared-attention), encoder-decoder, and modality-frontend (VLM /
audio) stacks.  src/repro/configs/<arch>.py instantiate it with the exact
assigned hyperparameters plus a reduced smoke variant.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3/DeepSeek-V2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256  # SSD chunk length
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0  # hybrid: one (shared) attention block every k layers
    shared_attn: bool = False  # zamba2: the attention block weights are shared
    # MLA
    mla: Optional[MLAConfig] = None
    # enc-dec
    n_enc_layers: int = 0  # family == encdec: encoder depth (n_layers = dec)
    # modality frontend stub: number of prefix embedding positions fed by
    # input_specs() (vision patches / audio frames)
    n_prefix: int = 0
    # attention variant
    sliding_window: int = 0  # 0 = full attention; >0 enables SW variant
    mla_chunk: int = 1024  # flash-chunked MLA; 0 = dense baseline (§Perf H2)
    loss_chunk: int = 0  # seq-chunked vocab loss; 0 = one-shot logits
    # >0 routes the MoE dispatch all_to_all through gz_all_to_all at this eb
    # (beyond-paper; pays at train shapes per benchmarks/moe_a2a_ablation)
    moe_dispatch_gz_eb: float = 0.0
    # use the Pallas flash-attention kernel (kernels/flash_attn.py) instead
    # of the pure-jnp chunked path; interpret-mode on CPU, real kernel on TPU
    use_flash_kernel: bool = False
    # PaLM-style parallel attention+MLP block: ONE TP psum per layer instead
    # of two (halves TP-collective bytes; changes the function — §Perf H3
    # beyond-paper variant, off for the faithful configs)
    parallel_block: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # citation for the assigned config (paper / model card)
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def padded_heads(self, tp: int) -> int:
        """q heads padded up to a multiple of tp (zero-init extras; their
        out-proj rows are zero so the function is unchanged — recorded in
        DESIGN.md hardware-adaptation notes)."""
        return -(-self.n_heads // tp) * tp if self.n_heads else 0

    def padded_vocab(self, quantum: int = 512) -> int:
        return -(-self.vocab // quantum) * quantum

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D accounting."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim or (d // max(self.n_heads, 1))
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        per_attn = d * n_q + 2 * d * n_kv + n_q * d
        per_mlp = 3 * d * ff
        if self.family == "moe":
            per_mlp *= self.n_experts
        per_layer = per_attn + per_mlp
        if self.family == "ssm":
            di = self.ssm.d_inner(d)
            per_layer = d * (2 * di + 2 * self.ssm.d_state) + di * d + di
        if self.family == "hybrid":
            di = self.ssm.d_inner(d)
            per_layer = d * (2 * di + 2 * self.ssm.d_state) + di * d + di
        total = self.n_layers * per_layer + (self.n_enc_layers or 0) * per_layer
        total += 2 * v * d  # embed + unembed
        return int(total)

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * 3 * d * ff * self.n_experts
        return int(dense + self.n_layers * 3 * d * ff * self.top_k)
