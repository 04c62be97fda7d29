"""Wall and peak memory of ``chip_smoke.py``'s moe sub-phases at a chosen
depth, on one card.

    python3 scripts/moe_depth_probe.py [--phi-layers 24] [--scout-layers 12]

Runs each sub-phase of the ``moe`` phase with ``chip_smoke.py``'s own
functions, in turn, each after a reset of the peak-memory counter: the
phi3.5-moe forward and decode check at ``--phi-layers``, serve's greedy
loop at that depth, the f32-weight decode check, the llama4-scout forward
at ``--scout-layers``, the smoke configs in f32 on card and CPU, and the
phi3.5-moe train step at 1 layer.  Each prints its wall and peak memory;
a sub-phase that fails (out of memory, a gate) prints its traceback and
the next one runs.  ``MOE_CUTS`` in ``chip_smoke.py`` is read off such a
run: the forward's peak and what a layer adds to it.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phi-layers", type=int, default=24)
    ap.add_argument("--scout-layers", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; free, total bytes "
          f"{torch.cuda.mem_get_info()}", flush=True)
    build.build_all()
    cs.MOE_CUTS[cs.MOE_ARCH] = (args.phi_layers,) + cs.MOE_CUTS[cs.MOE_ARCH][1:]
    cs.MOE_CUTS[cs.MOE_SCOUT] = (args.scout_layers,) + cs.MOE_CUTS[cs.MOE_SCOUT][1:]
    dev = torch.device("cuda")
    rel16 = []

    def serve_cut():
        with cs._registry_cut(cs.MOE_ARCH, args.phi_layers):
            cs._serve_steps(cs._moe_cfg(cs.MOE_ARCH), ["--arch", cs.MOE_ARCH], False, dev)

    steps = [
        ("phi3.5-moe forward and decode", lambda: rel16.append(cs._moe_forward(dev)[1])),
        ("serve at the cut", serve_cut),
        ("f32 decode", lambda: cs._moe_f32_decode(dev, rel16[0] if rel16 else float("nan"))),
        ("llama4-scout forward", lambda: cs._moe_scout_forward(dev)),
        ("smoke f32 card vs CPU", lambda: cs._check_moe_f32_card_vs_cpu(dev)),
        ("train step", lambda: cs.run_train_full_width(dev, cs.MOE_ARCH, cs.MOE_TRAIN_LAYERS,
                                                        cs.MOE_TRAIN_LEAF)),
    ]
    t0 = time.perf_counter()
    for name, fn in steps:
        t = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
            state = "ok"
        except Exception:  # noqa: BLE001 - report and go on to the next sub-phase
            traceback.print_exc()
            state = "FAILED"
        print(f"probe {name}: {state} in {time.perf_counter() - t:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"probe total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
