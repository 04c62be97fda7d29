"""Architecture registry: --arch <id> resolution for launchers/tests."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_67b,
    internlm2_20b,
    internvl2_26b,
    llama4_scout_17b_a16e,
    mamba2_780m,
    minicpm3_4b,
    minitron_8b,
    phi3_5_moe_42b,
    seamless_m4t_medium,
    zamba2_2_7b,
)

ARCHS = {
    "seamless-m4t-medium": seamless_m4t_medium,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "zamba2-2.7b": zamba2_2_7b,
    "minitron-8b": minitron_8b,
    "minicpm3-4b": minicpm3_4b,
    "mamba2-780m": mamba2_780m,
    "internlm2-20b": internlm2_20b,
    "deepseek-67b": deepseek_67b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "internvl2-26b": internvl2_26b,
}


def get(arch_id: str, *, smoke: bool = False):
    mod = ARCHS[arch_id]
    return mod.smoke() if smoke else mod.full()


def arch_ids():
    return list(ARCHS)
