"""Model assembly of ``repro/models/model.py``: init, forward, the decode
cache and the feature map.

``forward`` returns (logits, aux, cache): with ``use_cache`` it runs a
prefill or decode step against ``init_cache``'s state, written in place.
``features`` is the FedPFT foundation feature map (the ``f`` in the
paper's ``w = h ∘ f``): the input embedding, the block stack,
``rms_norm``, and a mean-pool over positions in f32.  ``loss_fn`` is the
training loss; it and ``final_hidden`` record an autograd graph (with
``cfg.remat``, each block under activation checkpointing), while
``forward`` and ``features`` serve under ``torch.no_grad()``.  Six
families run:

  dense   — token embedding, pre-norm GQA causal attention + MLP blocks
            (SwiGLU, squared ReLU or GELU)
  moe     — the dense blocks with a mixture of experts in place of the MLP
            (``layers.moe``); ``forward`` returns the summed aux loss
  vlm     — the dense decoder with a stubbed image prefix: ``batch["img"]``
            (B, n_img_tokens, img_embed_dim) through ``img_proj``, ahead
            of the text at positions 0 … n_img − 1
  encoder — frame projection, bidirectional RoPE attention + GELU-MLP blocks
  ssm     — token embedding, an RWKV6 stack (``models/rwkv.py``)
  hybrid  — token embedding, a Mamba2 stack (``models/mamba2.py``) with ONE
            shared causal attention + SwiGLU block after every
            ``attn_every`` layers (zamba2-style weight sharing), with one
            KV cache per use of the shared block

Parameters are a plain dict in the reference's layout: per-layer weights
stacked on a leading ``(L, …)`` axis, ``x @ W`` orientation.  A forward
splits each stack into its layers once (``_unstack``): under autograd one
``unbind`` gives each stack's gradient in one pass, where indexing layer
by layer would write a zero tensor the size of the whole stack per layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch import obs, resolve_device
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Positions, attention, dense_init,
                                       dense_stack, init_moe, mlp, moe,
                                       rms_norm)

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def n_img(cfg: ModelConfig) -> int:
    """Positions the image prefix takes ahead of the text (vlm only)."""
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


def _init_transformer_stack(cfg: ModelConfig, n_layers: int, dt,
                            generator: torch.Generator, dev) -> Params:
    """Stacked (L, …) transformer weights, drawn one layer at a time."""
    d, L = cfg.d_model, n_layers
    h, hk, dh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape):
        return dense_stack(L, shape, dt, generator, dev)
    w = {"ln1": torch.ones((L, d), dtype=dt, device=dev),
         "ln2": torch.ones((L, d), dtype=dt, device=dev),
         "wq": dense((d, h * dh)), "wk": dense((d, hk * dh)),
         "wv": dense((d, hk * dh)), "wo": dense((h * dh, d))}
    if cfg.n_experts:
        w.update(init_moe(cfg, L, dt, generator, dev))
        return w
    w.update(w_in=dense((d, ff)), w_out=dense((ff, d)))
    if cfg.mlp_variant == "swiglu":
        w["w_gate"] = dense((d, ff))
    return w


def _init_shared_attn_block(cfg: ModelConfig, dt, generator, dev) -> Params:
    """Zamba2's shared block: one full transformer block, reused."""
    stacked = _init_transformer_stack(cfg, 1, dt, generator, dev)
    return {k: v[0] for k, v in stacked.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random weights from ``generator``, the law of the reference's
    ``init_params`` (N(0, 1)/√fan_in, norms at one).  Every stack is
    drawn layer by layer on the device (``dense_stack``)."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d = cfg.d_model
    p: Params = {}
    if cfg.family == "encoder":
        p["blocks"] = _init_transformer_stack(cfg, cfg.n_layers, dt,
                                              generator, dev)
        p["frame_proj"] = dense_init((cfg.frame_embed_dim, d), dt, generator,
                                     dev)
        p["mask_emb"] = dense_init((d,), dt, generator, dev, scale=0.02)
    else:
        p["embed"] = dense_init((cfg.vocab_size, d), dt, generator, dev,
                                scale=0.02)
    if cfg.family == "vlm":
        p["img_proj"] = dense_init((cfg.img_embed_dim, d), dt, generator,
                                   dev)
    if cfg.family in ("dense", "moe", "vlm"):
        p["blocks"] = _init_transformer_stack(cfg, cfg.n_layers, dt,
                                              generator, dev)
    elif cfg.family == "ssm":
        p["blocks"] = rwkv_mod.init_rwkv_block(cfg, cfg.n_layers, dt,
                                               generator, dev)
    elif cfg.family == "hybrid":
        p["blocks"] = mamba_mod.init_mamba_block(cfg, cfg.n_layers, dt,
                                                 generator, dev)
        p["shared_attn"] = _init_shared_attn_block(cfg, dt, generator, dev)
    p["final_norm"] = torch.ones((d,), dtype=dt, device=dev)
    p["lm_head"] = dense_init((d, cfg.vocab_size), dt, generator, dev)
    return p


def _kv_shape(cfg: ModelConfig, n: int, batch: int, max_seq: int,
              window: int):
    """(n, batch, S, Hkv, D): a dense cache of max_seq slots, or a ring of
    min(max_seq, window) when windowed."""
    S = min(max_seq, window) if window else max_seq
    return (n, batch, S, cfg.n_kv_heads, cfg.head_dim)


def n_shared_uses(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int = 0,
               *, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Decode-time state sized for ``max_seq`` context: the RWKV6 state
    (ssm), the Mamba2 state plus one KV cache per use of the shared block
    (hybrid), or one KV cache per layer (dense, moe, vlm).  On ``cuda``
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_state(cfg, batch, dev)

    def kv(n):
        shape = _kv_shape(cfg, n, batch, max_seq, window)
        return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}
    if cfg.family == "hybrid":
        return {"mamba": mamba_mod.init_mamba_state(cfg, cfg.n_layers, batch,
                                                    dev),
                "shared_kv": kv(n_shared_uses(cfg))}
    return kv(cfg.n_layers)


def _embed_inputs(cfg: ModelConfig, params: Params, batch):
    """(x (B, S, d), positions (S,)): frames (B, S, F) through
    ``frame_proj`` for the encoder, token ids (B, S) through ``embed``
    otherwise, after the vlm's image prefix when ``batch`` has ``img``."""
    if cfg.family == "encoder":
        x = batch["frames"].to(_dtype(cfg)) @ params["frame_proj"]
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            params["mask_emb"].to(x.dtype), x)
    else:
        x = params["embed"][batch["tokens"].long()]
        if cfg.family == "vlm" and "img" in batch:
            img = batch["img"].to(_dtype(cfg)) @ params["img_proj"]
            x = torch.cat([img, x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _transformer_block(cfg: ModelConfig, x, w, *, positions,
                       window: int = 0, layer_cache=None):
    """One pre-norm block: (x, its MoE aux loss; 0 without experts).
    Positions that are each row's own (the server's decode) make each row
    its own MoE group, as the reference's ``vmap`` over slots does."""
    x = x + attention(rms_norm(x, w["ln1"]), w, cfg, positions=positions,
                      window=window, layer_cache=layer_cache)
    xn = rms_norm(x, w["ln2"])
    if cfg.n_experts:
        per_row = isinstance(positions, Positions) and positions.start is None
        y, aux = moe(xn, w, cfg, per_row=per_row)
        return x + y, aux
    return x + mlp(xn, w, cfg), 0.0


def _layer(blocks: Params, layer: int) -> Params:
    return {k: v[layer] for k, v in blocks.items()}


def _unstack(blocks: Params) -> List[Params]:
    """Each layer's weights of the stacked (L, …) ``blocks``: one
    ``unbind`` per leaf."""
    keys = list(blocks)
    return [dict(zip(keys, leaves))
            for leaves in zip(*(blocks[k].unbind(0) for k in keys))]


# each block function's span: model.transformer_block, model.mamba_block,
# model.rwkv_block
_SPAN_NAMES: Dict[Any, str] = {}


def _span_name(fn) -> str:
    name = _SPAN_NAMES.get(fn)
    if name is None:
        name = _SPAN_NAMES[fn] = "model." + fn.__name__.lstrip("_")
    return name


def _block(cfg: ModelConfig, fn, *args, **kw):
    """``fn(*args, **kw)`` (``args[1]`` the hidden state) in its
    ``model.<fn>`` span, under activation checkpointing when ``cfg.remat``
    and a graph is being recorded (the reference's ``jax.checkpoint``
    around each layer): the backward recomputes the block from its input
    instead of keeping its activations."""
    with obs.span(_span_name(fn), device=args[1]):
        if cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, preserve_rng_state=False,
                **kw)
        return fn(*args, **kw)


def _run_transformer(cfg: ModelConfig, x, blocks, cache=None, *, positions,
                     window: int = 0):
    """The transformer stack: (x, the summed MoE aux loss).  Layer l
    attends with ``cache``'s slice l when a cache is given."""
    aux = 0.0
    for layer, w in enumerate(_unstack(blocks)):
        x, a = _block(
            cfg, _transformer_block, cfg, x, w, positions=positions,
            window=window,
            layer_cache=None if cache is None else _layer(cache, layer))
        aux = aux + a
    return x, aux


def _store(state, layer: int, new) -> None:
    """Write one layer's new recurrent state into the stacked state."""
    for k, v in new.items():
        state[k][layer] = v


def _run_rwkv(cfg: ModelConfig, x, blocks, state=None, *,
              use_cache: bool = False):
    """The RWKV6 stack.  Without ``state`` every layer starts at zeros
    (one layer's zeros serve them all); with it, each layer starts from
    its slice and its new state is written back."""
    zero = None
    if state is None:
        zero = _layer(rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.device,
                                               n_layers=1), 0)
    for layer, w in enumerate(_unstack(blocks)):
        st = zero if state is None else _layer(state, layer)
        x, new = _block(cfg, rwkv_mod.rwkv_block, cfg, x, w, st,
                        use_cache=use_cache)
        if state is not None:
            _store(state, layer, new)
    return x


def _run_hybrid(cfg: ModelConfig, x, params, cache=None, *, positions,
                window: int = 0, use_cache: bool = False):
    """Mamba2 stack with the shared block after layers attn_every − 1,
    2·attn_every − 1, … (n_layers // attn_every uses); the last
    n_layers % attn_every layers are a tail without it.  With ``cache``
    each Mamba2 layer runs from its state and writes it back, and use u
    of the shared block attends with ``cache["shared_kv"]``'s slice u.
    Without it the reference's zero ``shared_kv`` has no counterpart."""
    A = cfg.attn_every
    zero = None
    if cache is None:
        zero = _layer(mamba_mod.init_mamba_state(cfg, 1, x.shape[0],
                                                 x.device), 0)
    for layer, w in enumerate(_unstack(params["blocks"])):
        st = zero if cache is None else _layer(cache["mamba"], layer)
        x, new = _block(cfg, mamba_mod.mamba_block, cfg, x, w, st,
                        use_cache=use_cache)
        if cache is not None:
            _store(cache["mamba"], layer, new)
        if (layer + 1) % A == 0:
            kv = (_layer(cache["shared_kv"], layer // A) if use_cache
                  else None)
            x, _ = _block(cfg, _transformer_block, cfg, x,
                          params["shared_attn"], positions=positions,
                          window=window, layer_cache=kv)
    return x


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, batch, *, cache: Any = None,
            positions=None, window: int = 0, use_cache: bool = False,
            last_only: bool = False):
    """Returns (logits (B, S, V) f32, aux, cache).

    ``positions``: absolute positions of the supplied tokens — None for
    0 … S−1, an int for a shared first position, or per-row positions
    ((B, S), or (B,) for one token a row; ``layers.Positions.of``).
    With ``use_cache`` the step reads and writes ``cache`` (from
    ``init_cache``) in place and returns it.  The ssm and hybrid stacks run from ``cache``'s
    recurrent state (zeros without one) and write their new state into
    it.  Logits are the ``cfg.dtype`` product cast to f32, as the
    reference computes them, then soft-capped when the config says so;
    aux is the MoE load-balancing loss summed over the layers (0 without
    experts).  ``last_only``: the logits of the last position alone, (B,
    1, V).
    """
    x, _ = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    P = Positions.of(positions, B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        cache = cache if cache is not None else rwkv_mod.init_rwkv_state(
            cfg, B, x.device)
        x = _run_rwkv(cfg, x, params["blocks"], cache, use_cache=use_cache)
    elif cfg.family == "hybrid":
        if cache is None:
            cache = {"mamba": mamba_mod.init_mamba_state(cfg, cfg.n_layers,
                                                         B, x.device),
                     "shared_kv": None}
            use_cache = False
        x = _run_hybrid(cfg, x, params, cache, positions=P, window=window,
                        use_cache=use_cache)
    else:
        x, moe_aux = _run_transformer(cfg, x, params["blocks"],
                                      cache if use_cache else None,
                                      positions=P, window=window)
        aux = aux + moe_aux
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"])
    return _logits(cfg, params, x), aux, cache


def _logits(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    """(B, S, V) f32: the ``cfg.dtype`` product cast to f32, soft-capped
    when the config says so."""
    logits = (x @ params["lm_head"]).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _hidden(cfg: ModelConfig, params: Params, batch, window: int = 0):
    """(post-norm hidden states (B, S, d), MoE aux loss f32): the block
    stack from zero state and no cache, as the reference's training
    forward runs it.  Records a graph when grad is on."""
    x, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = _run_rwkv(cfg, x, params["blocks"])
    elif cfg.family == "hybrid":
        x = _run_hybrid(cfg, x, params, positions=positions, window=window)
    else:
        x, moe_aux = _run_transformer(cfg, x, params["blocks"],
                                      positions=positions, window=window)
        aux = aux + moe_aux
    return rms_norm(x, params["final_norm"]), aux


def final_hidden(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Post-norm final hidden states (B, S, d)."""
    return _hidden(cfg, params, batch)[0]


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32, over the ``valid`` positions when
    given (at least one counted, as the reference divides)."""
    lp = torch.log_softmax(logits, dim=-1)
    ll = lp.gather(-1, labels.long()[..., None])[..., 0]
    if valid is None:
        return -ll.mean()
    valid = valid.float()
    return -(ll * valid).sum() / valid.sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params: Params, batch, window: int = 0):
    """Training loss → (total, {"xent", "aux"}), total = xent + aux.

    Batch keys per family (tensors on the parameters' device):
      LM (dense, moe, ssm, hybrid): tokens (B, S), labels (B, S)
      vlm: tokens, img, labels — labels align with the TEXT tokens only
      encoder: frames (B, S, F), mask (B, S) bool, targets (B, S); the
        loss counts the masked positions only
    The MoE aux is the load-balancing loss summed over the layers (0
    elsewhere).  Records a graph when grad is on.
    """
    x, aux = _hidden(cfg, params, batch, window)
    logits = _logits(cfg, params, x)
    if cfg.family == "encoder":
        loss = _xent(logits, batch["targets"], batch["mask"])
    elif cfg.family == "vlm":
        loss = _xent(logits[:, n_img(cfg):], batch["labels"])
    else:
        loss = _xent(logits, batch["labels"])
    return loss + aux, {"xent": loss, "aux": aux}


@torch.no_grad()
def features(cfg: ModelConfig, params: Params, batch,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """Mean-pooled final hidden state in f32: (B, d) features.

    ``batch`` holds ``frames`` (encoder) or ``tokens`` (the others), and
    ``img`` for a vlm's image prefix, whose positions are pooled with the
    text's as in the reference.  Runs on ``cuda`` unless
    ``device="cpu"``; the batch is moved there and the parameters must
    already live there.
    """
    dev = resolve_device(device)
    if params["final_norm"].device.type != dev.type:
        raise ValueError(f"features: parameters live on "
                         f"{params['final_norm'].device}, not {dev}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return final_hidden(cfg, params, batch).float().mean(dim=1)
