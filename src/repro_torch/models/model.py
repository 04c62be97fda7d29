"""Model assembly for every family of the reference: parameter trees,
loss forward, and one-token decode.

The counterpart of ``repro.models.model`` for dense GQA decoders
(minitron-8b, internlm2-20b, deepseek-67b), the dense decoder with
Multi-head Latent Attention (minicpm3-4b: ``cfg.mla`` set), the
Mixture-of-Experts decoders (phi3.5-moe-42b-a6.6b, llama4-scout-17b-a16e:
GQA attention and a routed expert FFN, ``models/moe.py``), the
Mamba2/SSD stack (mamba2-780m), the zamba2 hybrid (zamba2-2.7b: Mamba2
layers with ONE shared attention+MLP block after every ``attn_every`` of
them), the encoder-decoder (seamless-m4t-medium: a non-causal encoder
stack over the batch's ``enc_input`` frames, and decoder blocks that add
cross-attention to the encoder's output) and the prefix-frontend decoders
(vlm: internvl2-26b; audio: the batch's ``prefix`` embeddings placed
before the text, their rows dropped before the final norm).
``Model`` is an ``nn.Module`` whose parameters are registered under the
reference tree's names (``embed``, ``unembed``, ``final_norm``,
``blocks.attn.wq`` stacked (L, d, H*hd), ``blocks.cross.wk``,
``enc_blocks.mlp.wi``, ``blocks.mla.wkv_b``, ``blocks.moe.wi`` (L, E, d,
ff), ``blocks.ssm.A_log``, ``shared_attn.mlp.wi``, ...), so a JAX
parameter tree and this module's ``state_dict`` map one to one.
``loss_fn`` and ``decode_fn`` keep the reference's signatures and take a
params tree (``Model.params()``, or ``convert.params_from_jax``), so tests
call both packages alike.

The parameter definitions are GLOBAL, the same shapes at every tensor-
parallel size (the q heads padded to ``cfg.padded_heads(tp)``).  At
``ctx.tp_size > 1`` (ROADMAP A11.7) ``loss_fn``, ``decode_fn`` and
``cache_defs`` are rank-centric, as the reference's ``shard_map`` bodies:
each rank of a mesh calls them with its LOCAL block of every leaf
(``launch/training.py::_local`` of the global tree by the specs) and its
own block of the cache, and every rank gets the same loss and logits.
Every family runs there: the attention heads (GQA, MLA, the encoder's and
the cross attention's) and the SSD heads are split over the ranks, and
each row-parallel projection's partial sums are reduced over TP.  A
cache entry with no ``model`` dim (the MLA latent, the SSD ``conv_bc``,
``enc_out``) is the same on every rank: ranks that share one tensor for
it write the same values into it.

The reference's ``lax.scan`` over the stacked layers is a loop here.
Its ``jax.checkpoint`` of the scan body (``ctx.remat`` not ``"none"``)
is ``torch.utils.checkpoint`` of each layer when grad mode is on: the
layer's activations are recomputed in backward, with the same bits, and
a recompute inside an FSDP train step is bound to that step
(``grad_sync.fsdp_recompute_context``), so its gathers take the
forward's results.
The moe layers' router aux losses are summed over the layers, as the
reference's scan sums them, and ``loss_fn`` adds ``MOE_AUX_COEF`` times
their mean.  Decode writes the new k/v rows, latent rows and conv and
SSD states into the cache's tensors in place (the reference returns
updated copies); the encoder-decoder's step recomputes the cross k and v
from the cached ``enc_out`` every step, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.convert import tree_map
from repro_torch.core.grad_sync import fsdp_recompute_context
from repro_torch.core.transport import resolve_device
from repro_torch.models import attention, blocks, mla as mla_mod, moe as moe_mod, ssm as ssm_mod
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
from repro_torch.models.parallel import ParallelCtx, ParamDef, init_params, torch_dtype

__all__ = ["Model", "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01


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
    """A model of any family: dense (GQA or MLA), moe, ssm, hybrid,
    encdec, vlm or audio.

    ``params``: a tree of tensors (the reference's names and shapes) to
    register; without one, the GLOBAL parameters are drawn from ``seed``
    on ``device`` (``init_params``), which at tp > 1 a caller splits into
    the ranks' blocks.  ``device`` defaults to the card and
    raises without one; pass ``device="cpu"`` to run the plain versions.
    """

    def __init__(self, cfg: ModelConfig, ctx: ParallelCtx | None = None, *,
                 params: dict | None = None, device="cuda", seed: int = 0):
        super().__init__()
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

    def _dense_defs(self) -> dict:
        cfg, tp = self.cfg, self.ctx.tp_size
        return {
            "ln1": blocks.norm_def(cfg),
            "ln2": blocks.norm_def(cfg),
            "attn": blocks.attn_defs(cfg, tp),
            "mlp": blocks.mlp_defs(cfg),
        }

    def _block_defs(self, *, cross: bool = False) -> dict:
        """One layer's defs; ``cross``: the encdec decoder's cross-attention
        (``ln_cross``, ``cross``) beside its self-attention."""
        cfg, tp = self.cfg, self.ctx.tp_size
        fam = cfg.family
        if fam in ("dense", "vlm", "audio", "encdec"):
            if cfg.mla is not None:
                d = {"ln1": blocks.norm_def(cfg), "ln2": blocks.norm_def(cfg),
                     "mla": blocks.mla_defs(cfg, tp), "mlp": blocks.mlp_defs(cfg)}
            else:
                d = self._dense_defs()
            if cross:
                d["ln_cross"] = blocks.norm_def(cfg)
                d["cross"] = blocks.attn_defs(cfg, tp)
            return d
        if fam == "moe":
            return {"ln1": blocks.norm_def(cfg), "ln2": blocks.norm_def(cfg),
                    "attn": blocks.attn_defs(cfg, tp), "moe": blocks.moe_defs(cfg)}
        if fam in ("ssm", "hybrid"):
            return {"ln1": blocks.norm_def(cfg), "ssm": blocks.ssm_defs(cfg)}
        raise ValueError(fam)

    def param_defs(self) -> dict:
        cfg = self.cfg
        v = cfg.padded_vocab()
        d = cfg.d_model
        defs = {
            "embed": ParamDef((v, d), ("model", "data"), init="normal"),
            "unembed": ParamDef((d, v), ("data", "model"), init="scaled"),
            "final_norm": blocks.norm_def(cfg),
            "blocks": _stack(self._block_defs(cross=cfg.family == "encdec"), cfg.n_layers),
        }
        if cfg.family == "encdec":
            defs["enc_blocks"] = _stack(self._dense_defs(), cfg.n_enc_layers)
            defs["enc_norm"] = blocks.norm_def(cfg)
        if cfg.family == "hybrid" and cfg.attn_every:
            # zamba2: ONE shared attention+mlp block applied every k layers
            defs["shared_attn"] = self._dense_defs()
        return defs

    # ---------------- full-sequence forward / loss ----------------

    def _layers(self, h, stacked, layer, index, with_aux=False):
        """Apply ``layer`` with the stacked weights of each layer in
        ``index``, in order, each checkpointed under grad when remat is on.
        ``with_aux``: ``layer`` returns (h, aux); returns (h, the sum of
        the auxs)."""
        remat = self.ctx.remat != "none" and torch.is_grad_enabled()
        auxs = []
        for i in index:
            wl = _layer(stacked, i)
            if remat:
                # a recompute, on any thread, finds the forward's rank
                # handles, and its FSDP gathers take the forward's results
                out = checkpoint.checkpoint(layer, h, wl, use_reentrant=False,
                                            context_fn=fsdp_recompute_context)
            else:
                out = layer(h, wl)
            if with_aux:
                h, aux = out
                auxs.append(aux)
            else:
                h = out
        return (h, torch.sum(torch.stack(auxs))) if with_aux else h

    def _backbone(self, h, params, *, positions, window=0, cross_kv=None):
        """Run the decoder stack over hidden states h: (h, aux), aux the
        moe layers' summed router losses (0 for the other families).
        ``cross_kv``: the encoder's output, for the encdec decoder."""
        cfg, ctx = self.cfg, self.ctx
        fam = cfg.family
        layers = range(cfg.n_layers)
        if fam in ("dense", "vlm", "audio") and cfg.mla is None:
            h = self._layers(h, params["blocks"], lambda hh, wl: blocks.dense_block(
                hh, wl, cfg, ctx, positions=positions, window=window), layers)
        elif cfg.mla is not None:
            h = self._layers(h, params["blocks"], lambda hh, wl: blocks.mla_block(
                hh, wl, cfg, ctx, positions=positions), layers)
        elif fam == "moe":
            return self._layers(h, params["blocks"], lambda hh, wl: blocks.moe_block(
                hh, wl, cfg, ctx, positions=positions, window=window), layers, with_aux=True)
        elif fam == "ssm":
            h = self._layers(h, params["blocks"], self._ssm_layer, layers)
        elif fam == "hybrid":
            h = self._hybrid_train(h, params, positions=positions, window=window)
        elif fam == "encdec":
            h = self._layers(h, params["blocks"], lambda hh, wl: blocks.dense_block(
                hh, wl, cfg, ctx, positions=positions, cross_kv=cross_kv), layers)
        else:
            raise ValueError(fam)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def _ssm_layer(self, h, wl):
        return blocks.ssm_block(h, wl, self.cfg, self.ctx)

    def _hybrid_train(self, h, params, *, positions, window=0):
        """Groups of ``attn_every`` ssm layers, each followed by the shared
        dense block (not checkpointed, as in the reference), then the
        remainder."""
        cfg, ctx = self.cfg, self.ctx
        k = cfg.attn_every
        n_groups = cfg.n_layers // k
        for g in range(n_groups):
            h = self._layers(h, params["blocks"], self._ssm_layer, range(g * k, (g + 1) * k))
            h = blocks.dense_block(h, params["shared_attn"], cfg, ctx, positions=positions,
                                   window=window)
        return self._layers(h, params["blocks"], self._ssm_layer,
                            range(n_groups * k, cfg.n_layers))

    def _encode(self, params, enc_input):
        """The encdec encoder: ``enc_input`` (B, S_enc, d) cast to
        ``cfg.dtype``, the non-causal dense blocks with RoPE positions from
        0 over S_enc (checkpointed as the decoder's under remat), then
        ``enc_norm``."""
        cfg, ctx = self.cfg, self.ctx
        h = enc_input.to(torch_dtype(cfg.dtype))
        positions = torch.arange(h.shape[1], device=h.device)
        h = self._layers(h, params["enc_blocks"], lambda hh, wl: blocks.dense_block(
            hh, wl, cfg, ctx, positions=positions, causal=False), range(cfg.n_enc_layers))
        return rms_norm(h, params["enc_norm"], cfg.norm_eps)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """batch: tokens (B,S), labels (B,S) [-1 = masked], numpy or tensors;
        prefix (B,n_prefix,d) for vlm and audio, enc_input (B,S_enc,d) for
        encdec."""
        cfg, ctx = self.cfg, self.ctx
        dev = params["embed"].device
        tokens = _as_tensor(batch["tokens"], dev)
        h = embed_lookup(tokens, params["embed"], ctx)
        cross_kv = None
        if cfg.family == "encdec":
            cross_kv = self._encode(params, _as_tensor(batch["enc_input"], dev))
        prefixed = bool(cfg.n_prefix) and cfg.family in ("vlm", "audio")
        if prefixed:
            h = torch.cat([_as_tensor(batch["prefix"], dev).to(h.dtype), h], dim=1)
        positions = torch.arange(h.shape[1], device=dev)
        h, aux = self._backbone(h, params, positions=positions, cross_kv=cross_kv,
                                window=cfg.sliding_window if cfg.sliding_window else 0)
        if prefixed:
            h = h[:, cfg.n_prefix:]
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        labels = _as_tensor(batch["labels"], dev)
        mask = (labels >= 0).to(torch.float32)
        labels = torch.clamp(labels, min=0)
        if cfg.loss_chunk:
            loss = chunked_vocab_xent(h, params["unembed"], labels, mask, ctx,
                                      chunk=cfg.loss_chunk)
        else:
            logits = vocab_parallel_logits(h, params["unembed"], ctx)
            loss = vocab_parallel_xent(logits, labels, ctx, mask=mask)
        if cfg.family == "moe":
            loss = loss + MOE_AUX_COEF * aux / cfg.n_layers
        return loss

    # ---------------- decode (one token) ----------------

    def cache_defs(self, batch_local: int, spec: KVCacheSpec) -> dict:
        """LOCAL cache shapes.  dense, vlm, audio and moe: k and v, each (L,
        B, S_local, kv_local, hd); MLA: mla (L, B, S_total, kv_lora +
        rope_dim), the latent and rope-key rows; ssm: conv_x (L, B, W-1,
        di), conv_bc (L, B, W-1, 2n) and ssm (L, B, H, p, n); hybrid: the
        ssm entries plus k and v with one lead row per shared-attention
        application; encdec: the decoder's k and v, and enc_out (B, S_enc,
        d), the encoder's output (S_enc ``n_prefix``, 128 without one)."""
        cfg, tp = self.cfg, self.ctx.tp_size
        L = cfg.n_layers
        if cfg.mla is not None:
            return {"mla": (L, batch_local, spec.s_total, mla_mod.mla_cache_dims(cfg))}
        kvl = attention.kv_local_heads(cfg, tp)
        shape = (L, batch_local, spec.s_local, kvl, cfg.head_dim)
        if cfg.family in ("dense", "vlm", "audio", "moe"):
            return {"k": shape, "v": shape}
        if cfg.family == "encdec":
            return {"k": shape, "v": shape,
                    "enc_out": (batch_local, cfg.n_prefix or 128, cfg.d_model)}
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(cfg.family)
        conv, state = ssm_mod.ssm_state_shapes(cfg, tp, batch_local)
        di_l = cfg.ssm.d_inner(cfg.d_model) // tp
        out = {"conv_x": (L,) + conv[:-1] + (di_l,),
               "conv_bc": (L,) + conv[:-1] + (2 * cfg.ssm.d_state,),
               "ssm": (L,) + state}
        if cfg.family == "hybrid":
            shape = (L // cfg.attn_every, batch_local, spec.s_local, kvl, cfg.head_dim)
            out["k"], out["v"] = shape, shape
        return out

    def _attn_mlp_decode(self, h, w, cache_k, cache_v, pos, spec, enc_out=None):
        """One layer's step: self-attention against the cache, then (with
        ``enc_out``, the encdec decoder) non-causal cross-attention over the
        encoder's output, then the MLP or the moe FFN."""
        cfg, ctx = self.cfg, self.ctx
        a, _, _ = attention.attention_decode(
            rms_norm(h, w["ln1"], cfg.norm_eps), w["attn"], cache_k, cache_v, pos, cfg,
            ctx, spec)
        h = h + a
        if enc_out is not None:
            h = h + attention.attention_train(  # no RoPE in the cross path: no positions
                rms_norm(h, w["ln_cross"], cfg.norm_eps), w["cross"], cfg, ctx, positions=None,
                causal=False, cross_kv=enc_out)
        x = rms_norm(h, w["ln2"], cfg.norm_eps)
        if "moe" in w:  # the moe family's layers; the B tokens routed as a batch
            return h + moe_mod.moe_ffn(x, w["moe"], cfg, ctx)[0]
        return h + blocks._mlp(x, w["mlp"], ctx)

    def _ssm_decode(self, h, wl, cache, i):
        """Layer ``i``'s one-token SSD step; its new conv and SSD states
        are written into the cache's rows ``i``."""
        cfg = self.cfg
        cx, cbc, cs = cache["conv_x"][i], cache["conv_bc"][i], cache["ssm"][i]
        y, nconv, nssm = ssm_mod.ssm_decode(
            rms_norm(h, wl["ln1"], cfg.norm_eps), wl["ssm"], torch.cat([cx, cbc], dim=-1),
            cs, cfg, self.ctx)
        di_l = cx.shape[-1]
        cx.copy_(nconv[..., :di_l])
        cbc.copy_(nconv[..., di_l:])
        cs.copy_(nssm)
        return h + y

    def decode_fn(self, params, cache, tokens, pos, spec: KVCacheSpec):
        """One decode step.  tokens: (B, 1) ints; pos: the absolute position
        (an int).  Returns (logits (B, 1, V_pad) f32, new_cache); the new
        token's k and v (or latent row) and the new conv and SSD states are
        written into ``cache``'s tensors in place."""
        cfg, ctx = self.cfg, self.ctx
        dev = params["embed"].device
        h = embed_lookup(_as_tensor(tokens, dev), params["embed"], ctx)
        pos = int(pos)
        fam = cfg.family
        if fam in ("dense", "vlm", "audio", "moe", "encdec") and cfg.mla is None:
            # encdec: the encoder's output in the embedding's dtype, as the
            # reference's decode casts it (its prefill keeps cfg.dtype)
            enc_out = cache["enc_out"].to(h.dtype) if fam == "encdec" else None
            for i in range(cfg.n_layers):
                h = self._attn_mlp_decode(h, _layer(params["blocks"], i), cache["k"][i],
                                          cache["v"][i], pos, spec, enc_out)
        elif cfg.mla is not None:
            for i in range(cfg.n_layers):
                wl = _layer(params["blocks"], i)
                a, _ = mla_mod.mla_decode(rms_norm(h, wl["ln1"], cfg.norm_eps), wl["mla"],
                                          cache["mla"][i], pos, cfg, ctx)
                h = h + a
                h = h + blocks._mlp(rms_norm(h, wl["ln2"], cfg.norm_eps), wl["mlp"], ctx)
        elif fam in ("ssm", "hybrid"):
            k = cfg.attn_every if fam == "hybrid" else 0
            for i in range(cfg.n_layers):
                h = self._ssm_decode(h, _layer(params["blocks"], i), cache, i)
                if k and (i + 1) % k == 0:  # the shared block after each group
                    g = i // k
                    h = self._attn_mlp_decode(h, params["shared_attn"], cache["k"][g],
                                              cache["v"][g], pos, spec)
        else:
            raise ValueError(fam)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = vocab_parallel_logits(h, params["unembed"], ctx)
        return gather_logits(logits, ctx), dict(cache)
