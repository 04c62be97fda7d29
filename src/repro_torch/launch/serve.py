"""Serving entry point: batched greedy decode with a KV/state cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --batch 4 --prompt-len 16 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The counterpart of ``repro.launch.serve``: the same flags (plus
``--device``, default ``cuda``), the same decode-path prefill (the prompt
goes through ``Model.decode_fn`` one token at a time, so there is one code
path) and greedy loop, the same two printed lines, the same default
``--arch`` (``mamba2-780m``).  Every family runs; the encdec family's
cached encoder output is drawn from the seed's generator before the
prompt, as the reference draws it (the frontend is a stub), so the prompt
tokens are the reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.transport import resolve_device
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.model import Model
from repro_torch.models.parallel import ParallelCtx

__all__ = ["serve"]


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m", choices=registry.arch_ids())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    model = Model(cfg, ParallelCtx(), device=device, seed=args.seed)
    # the CLI runs one rank, so it never splits the context (the split is
    # launch.training.make_serve_step's, on a mesh with data > 1)
    plan = KVCacheSpec(s_total=args.cache_len, cp_axis=None, cp_size=1)
    shapes = model.cache_defs(args.batch, plan)
    rng = np.random.default_rng(args.seed)
    cache = {k: torch.zeros(v, dtype=torch.float32, device=device)
             for k, v in shapes.items()}
    if "enc_out" in cache:
        cache["enc_out"] = torch.from_numpy(
            rng.normal(0, 1, shapes["enc_out"]).astype(np.float32)).to(device)
    params = model.params()
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    prompt = torch.from_numpy(prompt).to(device)

    # prefill token-by-token (decode-path prefill keeps one code path)
    t0 = time.time()
    tok = None
    out_tokens = []
    with torch.inference_mode():
        for i in range(args.prompt_len + args.gen):
            if i < args.prompt_len:
                tok = prompt[:, i:i + 1]
            logits, cache = model.decode_fn(params, cache, tok, i, plan)
            nxt = torch.argmax(logits[:, :, :cfg.vocab], dim=-1).to(torch.int32)
            if i >= args.prompt_len - 1:
                tok = nxt
                out_tokens.append(nxt[:, 0].cpu().numpy())
    dt = time.time() - t0
    gen = np.stack(out_tokens, axis=1)
    n_tok = args.batch * (args.prompt_len + args.gen)
    print(f"arch={cfg.arch_id} decoded {gen.shape[1]} tokens x{args.batch} "
          f"in {dt:.2f}s ({n_tok/dt:.1f} tok/s incl. prefill)")
    print("sample:", gen[0][:16])
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("serve: non-finite logits")
    return gen


if __name__ == "__main__":
    serve()
