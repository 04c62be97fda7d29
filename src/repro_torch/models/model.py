"""Model assembly for the dense family: parameter tree, loss forward, and
one-token decode.

The counterpart of ``repro.models.model`` for dense GQA decoders
(minitron-8b, internlm2-20b, deepseek-67b) on one card.  ``Model`` is an
``nn.Module`` whose parameters are registered under the reference tree's
names (``embed``, ``unembed``, ``final_norm``, ``blocks.attn.wq`` stacked
(L, d, H*hd), ...), so a JAX parameter tree and this module's
``state_dict`` map one to one.  ``loss_fn`` and ``decode_fn`` keep the
reference's signatures and take a params tree (``Model.params()``, or
``convert.params_from_jax``), so tests call both packages alike.

The reference's ``lax.scan`` over the stacked layers is a loop here.
Its ``jax.checkpoint`` of the scan body (``ctx.remat`` not ``"none"``)
is ``torch.utils.checkpoint`` of each layer when grad mode is on: the
layer's activations are recomputed in backward, with the same bits.
Families other than dense
(moe, MLA, ssm, hybrid, encdec, vlm, audio) raise ``NotImplementedError``:
they are ROADMAP A15.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.convert import tree_map
from repro_torch.core.transport import resolve_device
from repro_torch.models import attention, blocks
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    chunked_vocab_xent,
    embed_lookup,
    gather_logits,
    rms_norm,
    vocab_parallel_logits,
    vocab_parallel_xent,
)
from repro_torch.models.parallel import ParallelCtx, ParamDef, init_params

__all__ = ["Model"]


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration whose family this port does not run yet."""
    if cfg.family != "dense" or cfg.mla is not None or cfg.n_prefix:
        kind = "MLA" if cfg.mla is not None else cfg.family
        raise NotImplementedError(
            f"{cfg.arch_id}: the {kind} family is not ported yet (ROADMAP A15); "
            "the port runs the dense GQA family")


def _stack(defs, L: int):
    """Add a leading stacked-layer dim to every ParamDef in a tree."""
    return tree_map(
        lambda d: dataclasses.replace(d, shape=(L,) + d.shape, spec=(None,) + tuple(d.spec)),
        defs)


def _layer(stacked, i: int):
    """Layer ``i`` of a tree of stacked parameters."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class _Params(nn.Module):
    """A node of the parameter tree."""


def _register(module: nn.Module, tree: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            sub = _Params()
            _register(sub, val)
            module.add_module(key, sub)
        else:
            module.register_parameter(key, nn.Parameter(val, requires_grad=False))


def _tree_of(module: nn.Module) -> dict:
    out: dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, sub in module.named_children():
        out[name] = _tree_of(sub)
    return out


class Model(nn.Module):
    """The dense GQA decoder.

    ``params``: a tree of tensors (the reference's names and shapes) to
    register; without one, the parameters are drawn from ``seed`` on
    ``device`` (``init_params``).  ``device`` defaults to the card and
    raises without one; pass ``device="cpu"`` to run the plain versions.
    """

    def __init__(self, cfg: ModelConfig, ctx: ParallelCtx | None = None, *,
                 params: dict | None = None, device="cuda", seed: int = 0):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else ParallelCtx()
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(self.param_defs(), gen, dev)
        _register(self, params)

    def params(self) -> dict:
        """The registered parameters as the reference's tree."""
        return _tree_of(self)

    def forward(self, batch) -> torch.Tensor:
        return self.loss_fn(self.params(), batch)

    # ---------------- parameter definitions ----------------

    def _block_defs(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp_size
        return {
            "ln1": blocks.norm_def(cfg),
            "ln2": blocks.norm_def(cfg),
            "attn": blocks.attn_defs(cfg, tp),
            "mlp": blocks.mlp_defs(cfg),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        v = cfg.padded_vocab()
        d = cfg.d_model
        return {
            "embed": ParamDef((v, d), ("model", "data"), init="normal"),
            "unembed": ParamDef((d, v), ("data", "model"), init="scaled"),
            "final_norm": blocks.norm_def(cfg),
            "blocks": _stack(self._block_defs(), cfg.n_layers),
        }

    # ---------------- full-sequence forward / loss ----------------

    def _backbone(self, h, params, *, positions, window=0, cross_kv=None):
        """Run the decoder stack over hidden states h: (h, aux = 0)."""
        cfg, ctx = self.cfg, self.ctx

        def layer(hh, wl):
            return blocks.dense_block(hh, wl, cfg, ctx, positions=positions, window=window)

        remat = ctx.remat != "none" and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            wl = _layer(params["blocks"], i)
            if remat:
                h = checkpoint.checkpoint(layer, h, wl, use_reentrant=False)
            else:
                h = layer(h, wl)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """batch: tokens (B,S), labels (B,S) [-1 = masked], numpy or tensors."""
        cfg, ctx = self.cfg, self.ctx
        dev = params["embed"].device
        tokens = _as_tensor(batch["tokens"], dev)
        h = embed_lookup(tokens, params["embed"], ctx)
        positions = torch.arange(h.shape[1], device=dev)
        h, _ = self._backbone(h, params, positions=positions,
                              window=cfg.sliding_window if cfg.sliding_window else 0)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        labels = _as_tensor(batch["labels"], dev)
        mask = (labels >= 0).to(torch.float32)
        labels = torch.clamp(labels, min=0)
        if cfg.loss_chunk:
            return chunked_vocab_xent(h, params["unembed"], labels, mask, ctx,
                                      chunk=cfg.loss_chunk)
        logits = vocab_parallel_logits(h, params["unembed"], ctx)
        return vocab_parallel_xent(logits, labels, ctx, mask=mask)

    # ---------------- decode (one token) ----------------

    def cache_defs(self, batch_local: int, spec: KVCacheSpec) -> dict:
        """Cache shapes: k and v, each (L, B, S_local, kv_local, hd)."""
        cfg = self.cfg
        kvl = attention.kv_local_heads(cfg, self.ctx.tp_size)
        shape = (cfg.n_layers, batch_local, spec.s_local, kvl, cfg.head_dim)
        return {"k": shape, "v": shape}

    def decode_fn(self, params, cache, tokens, pos, spec: KVCacheSpec):
        """One decode step.  tokens: (B, 1) ints; pos: the absolute position
        (an int).  Returns (logits (B, 1, V_pad) f32, new_cache); the new
        token's k and v are written into ``cache``'s tensors in place."""
        cfg, ctx = self.cfg, self.ctx
        dev = params["embed"].device
        h = embed_lookup(_as_tensor(tokens, dev), params["embed"], ctx)
        pos = int(pos)
        for i in range(cfg.n_layers):
            wl = _layer(params["blocks"], i)
            a, _, _ = attention.attention_decode(
                rms_norm(h, wl["ln1"], cfg.norm_eps), wl["attn"], cache["k"][i],
                cache["v"][i], pos, cfg, ctx, spec)
            h = h + a
            h = h + blocks._mlp(rms_norm(h, wl["ln2"], cfg.norm_eps), wl["mlp"], ctx)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = vocab_parallel_logits(h, params["unembed"], ctx)
        return gather_logits(logits, ctx), dict(cache)
