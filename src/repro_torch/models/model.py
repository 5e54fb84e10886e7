"""Model assembly for the port: an LM (embedding, a stack of global, local,
recurrent and ssm blocks in the order of ``cfg.layer_kinds()``, final
norm, greedy head) — the path deepseek-7b, gemma2-27b, gemma-2b,
recurrentgemma-9b, qwen2-vl-7b (M-RoPE; tokens, or stub patch embeddings
in their place), mamba2-130m (Mamba2 SSD blocks alone) and dbrx-132b
(global blocks whose MLP half is a mixture of experts) serving run in
``repro/models/model.py`` — the
XLM-R encoder (``cfg.family == "encoder"``: the same stack, non-causal,
with LayerNorm, q/k/v biases and a plain biased MLP), whose hidden states
mode 'full' gives, and whisper's encoder-decoder (``cfg.encdec``): a
non-causal encoder over stub frame embeddings (``encode``), then a decoder
of ``decoder`` blocks whose cross-attention reads each layer's keys and
values of the encoder's output (``build_cross_kv``). The JAX package
scans stacked layer parameters with ``jax.lax.scan``; here the layers are
an ``nn.ModuleList`` walked by a Python loop, and the caches a list with
one dict per layer (an enc-dec decoder layer's also holds its cross K/V,
``cross_k`` and ``cross_v``, where the reference keeps ``caches["cross"]``).
Training's ``loss_fn`` runs the same stack in mode 'train': attention in
plain torch, which autograd differentiates, and the MoE load-balance loss
carried through the layers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      SSM, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import dtype_of, make_norm, mk_param
from repro_torch.sharding import vocab as vocab_mod


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that uses a feature the port does not have yet."""
    unsupported = {
        "block kinds other than global, local, recurrent and ssm":
            not set(cfg.block_pattern) <= {ATTN_GLOBAL, ATTN_LOCAL,
                                           RECURRENT, SSM},
        # tokens, or stub embeddings in their place (an enc-dec model's
        # encoder frames, qwen2-vl's patches)
        f"embedding inputs of kind {cfg.input_kind!r}":
            cfg.input_kind not in ("tokens", "embeddings"),
    }
    missing = [name for name, used in unsupported.items() if used]
    if missing:
        raise NotImplementedError(f"{cfg.name}: the port does not support "
                                  f"{', '.join(missing)} yet")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        check_supported(cfg)
        dt = dtype_of(cfg.param_dtype)
        Vp = vocab_mod.padded_vocab(cfg)
        self.embed = mk_param((Vp, cfg.d_model), dt, device, gen)
        self.layers = nn.ModuleList(blk.Block(cfg, gen, device, kind)
                                    for kind in layer_kinds(cfg))
        self.final_norm = make_norm(cfg, dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = mk_param((Vp, cfg.d_model), dt, device, gen)
        if cfg.encdec is not None:
            self.enc_layers = nn.ModuleList(
                blk.Block(cfg, gen, device, ATTN_GLOBAL)
                for _ in range(cfg.encdec.encoder_layers))
            self.enc_final_norm = make_norm(cfg, dt, device)


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kind of each (decoder) layer: ``cfg.layer_kinds()``, each
    one ``decoder`` for an enc-dec config, as the reference builds it."""
    if cfg.encdec is not None:
        return (blk.DECODER,) * cfg.num_layers
    return cfg.layer_kinds()


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX package's distributions (not its bits: ``jax.random`` and
    ``torch.Generator`` differ, so tests carry JAX weights across with
    ``repro_torch.convert``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, device)


def model_device(params: Model) -> torch.device:
    return params.embed.device


def off_device(params: nn.Module, device) -> List[Tuple[str, torch.device]]:
    """(name, device) of every parameter and buffer of ``params`` (a
    ``QuantDense`` leaf's ``q8`` and ``scale`` included) not on
    ``device``."""
    device = torch.device(device)
    leaves = list(params.named_parameters()) + list(params.named_buffers())
    return [(name, t.device) for name, t in leaves if t.device != device]


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda", enc_len: Optional[int] = None
                ) -> List[attn_mod.Cache]:
    """One preallocated cache dict per layer: K/V for an attention layer, a
    ring of ``min(window_size, max_len)`` slots for a local one (int8
    values and fp16 scales when ``cfg.quant.kv_cache_dtype == "int8"``);
    ``h`` and ``conv`` for a recurrent layer (``rglru.init_rglru_cache``),
    ``state`` and ``conv`` for an ssm layer (``ssm.init_ssm_cache``),
    whatever the KV cache's format. An enc-dec config's decoder layer
    holds a global layer's K/V and, for the ``enc_len`` frames of the
    encoder's output, ``cross_k`` and ``cross_v`` (B, enc_len, K, hd) in
    the activation dtype, which prefill fills in place (a captured decode
    reads them where they are)."""
    state = {RECURRENT: rglru_mod.init_rglru_cache,
             SSM: ssm_mod.init_ssm_cache}
    caches = [state[kind](cfg, batch, device) if kind in state
              else attn_mod.init_kv_cache(cfg, batch, max_len, device, kind)
              for kind in cfg.layer_kinds()]
    if cfg.encdec is not None:
        if enc_len is None:
            raise ValueError(f"{cfg.name}: an enc-dec model's caches need "
                             f"enc_len, the encoder frames")
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        dt = dtype_of(cfg.activation_dtype)
        for c in caches:
            c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return caches


def cache_extents(cfg: ModelConfig, caches
                  ) -> Tuple[Optional[int], Optional[int]]:
    """(positions a global layer's row holds, slots a local layer's ring
    holds) of ``init_caches``' caches, None for a kind the model has no
    layer of: the bounds of a chunk call's writes (``chunk_writes``), read
    here by the engine and by ``chunk_prefill_step`` alike. A recurrent or
    ssm layer's state has no positions and bounds nothing."""
    extent = {kind: c["k"].shape[1]
              for c, kind in zip(caches, cfg.layer_kinds())
              if kind in (ATTN_GLOBAL, ATTN_LOCAL)}
    return extent.get(ATTN_GLOBAL), extent.get(ATTN_LOCAL)


def encode(params: Model, cfg: ModelConfig, enc_embeds: torch.Tensor,
           enc_valid: Optional[torch.Tensor] = None,
           mode: str = "full") -> torch.Tensor:
    """The encoder of an enc-dec model: stub frame embeddings (B,T,d) in
    the activation dtype through its non-causal stack (RoPE at positions
    0..T-1), frames past ``enc_valid`` (B,T), the real frames of
    right-padded rows, masked as keys; then its final norm. -> (B,T,d).
    ``mode`` 'train' runs the blocks' differentiable attention."""
    device = model_device(params)
    x = enc_embeds.to(device=device, dtype=dtype_of(cfg.activation_dtype))
    B, T = x.shape[:2]
    positions = torch.arange(T, device=device).expand(B, T)
    if enc_valid is not None:
        enc_valid = enc_valid.to(device)
    for layer in params.enc_layers:
        x = blk.apply_block(layer, x, cfg, mode=mode, cache=None,
                            positions=positions, kv_valid=enc_valid,
                            causal=False)
    return params.enc_final_norm(x, cfg.norm_eps)


def build_cross_kv(params: Model, cfg: ModelConfig, enc_hidden: torch.Tensor
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross-attention (k, v), each (B,T,K,hd), from
    the encoder's output (B,T,d)."""
    return [attn_mod.cross_kv(layer.xattn, enc_hidden, cfg)
            for layer in params.layers]


def _write_cross(caches, cross, rows: torch.Tensor) -> None:
    """Prefill's cross K/V into the caches' ``cross_k``/``cross_v`` in
    place, batch row j into cache row ``rows[j]`` (a negative entry: a
    padded group row, as ``attention.fill_cache_from_prefill`` writes)."""
    for c, (k, v) in zip(caches, cross):
        if c["cross_k"].shape[1] != k.shape[1]:
            raise ValueError(f"the caches hold {c['cross_k'].shape[1]} "
                             f"encoder frames, the batch {k.shape[1]}")
        attn_mod.fill_cache_from_prefill(
            {"k": c["cross_k"], "v": c["cross_v"]}, k, v, rows, ATTN_GLOBAL)


def _default_positions(cfg: ModelConfig, B: int, S: int,
                      device) -> torch.Tensor:
    """Positions 0..S-1 of every row, (B,S); for M-RoPE the same in each of
    the (t, h, w) streams, (3,B,S) (the reference's
    ``_default_positions``)."""
    pos = torch.arange(S, device=device).expand(B, S)
    if cfg.rope_mode == "mrope":
        pos = pos[None].expand(3, B, S)
    return pos


def _embed_inputs(params: Model, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stack's input (B,S,d): ``batch["embeds"]`` (B,S,d) for a config
    of ``input_kind == "embeddings"`` that is given them (cast to the
    activation dtype, times ``embedding_multiplier`` rounded to that dtype
    where set), else the embedded ``batch["tokens"]`` (B,S) (the
    reference's ``_embed_inputs``)."""
    device = model_device(params)
    if cfg.input_kind == "embeddings" and "embeds" in batch:
        x = batch["embeds"].to(device=device,
                               dtype=dtype_of(cfg.activation_dtype))
        if cfg.embedding_multiplier:
            x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype,
                                 device=device)
        return x
    return vocab_mod.embed_lookup(params.embed, batch["tokens"].to(device),
                                  cfg)


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str, caches: Optional[List[attn_mod.Cache]],
            pos: Optional[torch.Tensor] = None,
            kv_valid: Optional[torch.Tensor] = None,
            cache_rows: Optional[torch.Tensor] = None,
            chunk: Optional[attn_mod.ChunkCoords] = None,
            active=None, remat: bool = False
            ) -> Tuple[torch.Tensor, List[attn_mod.Cache]]:
    """Returns (hidden (B,S,d), caches); the caches are updated in place.
    Every shape follows the inputs' shapes (none follows their values), and
    nothing waits on the device, so a serving stage built on it can be
    captured as a CUDA graph.

    The batch holds 'tokens' (B,S), or (a config of ``input_kind ==
    "embeddings"``) 'embeds' (B,S,d) in their place (``_embed_inputs``);
    in modes 'full' and 'prefill' it may hold 'positions', (B,S) or (3,B,S)
    for M-RoPE, else they are ``_default_positions``. Chunks and decode
    steps take their positions from their offsets (one stream, broadcast
    to all three for M-RoPE), as the reference's do.

    mode 'full': batch {'tokens' (B,S)}, over every position (causal, but
    not for an encoder config, as in the reference), no caches (pass None;
    the build step's calibration forward, and the encoder's serving
    mode); ``kv_valid`` (B,S), if given, marks real tokens of right-padded
    rows, and no query attends a padded key.
    mode 'train': as 'full', through what autograd differentiates (each
    block's attention in plain torch, ``attention.dense_attention``: the
    kernels have no backward); returns (hidden, aux), aux the summed MoE
    load-balance loss of the layers (an f32 scalar, 0 without experts), as
    the reference's forward carries it. ``remat`` recomputes each (decoder)
    layer in the backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scan unit) instead of keeping its
    activations.
    mode 'prefill': the same as 'full', right-padded, ``kv_valid`` (B,S)
    marking real tokens; batch row j's state (K/V, or a recurrent layer's
    exit state) goes to cache row ``cache_rows[j]`` (default row j); a
    negative entry marks a padded group row, which writes nothing of its
    own.
    mode 'chunk': batch {'tokens' (P,C)}, one prompt chunk per group row at
    the coordinates ``chunk`` (see ``chunk_prefill_step``).
    mode 'decode': batch {'tokens' (B,1)} at per-row positions ``pos``
    (B,); ``active`` (B,) bool (host array or tensor) marks the rows really
    decoding — the others leave their cache as it was.

    An enc-dec config's batch also holds ``enc_embeds`` (B,T,d) in modes
    'full' and 'prefill', and may hold ``enc_valid`` (B,T): the encoder
    runs, each decoder layer's cross K/V is built from its output (and in
    'prefill' written into the caches' cross buffers, which the layers
    then read), and cross-attention masks the frames past ``enc_valid``.
    Mode 'decode' reads the cross K/V from the caches and attends every
    frame: the reference's ``decode_step`` passes no ``enc_valid``.
    """
    device = model_device(params)
    x = _embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = rows = None
    causal = cfg.family != "encoder"
    if mode in ("full", "train", "prefill"):
        positions = batch.get("positions")
        positions = _default_positions(cfg, B, S, device) \
            if positions is None else positions.to(device)
        if kv_valid is not None:
            kv_valid = kv_valid.to(device)
    if mode in ("full", "train"):
        caches = [None] * cfg.num_layers
    elif mode == "prefill":
        rows = (torch.arange(B, device=device) if cache_rows is None
                else cache_rows.to(device))
    elif mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32).to(device)
        if pos.dim() == 0:                     # one position for every row
            pos = pos.expand(B).contiguous()
        if active is not None:
            active = torch.as_tensor(active, dtype=torch.bool).to(device)
    cross, cross_valid = [None] * cfg.num_layers, None
    if cfg.encdec is not None and mode != "chunk":   # the blocks refuse it
        cross, cross_valid = _cross_inputs(params, cfg, batch, mode, caches,
                                           rows)
    if mode == "train":
        x, aux = _train_stack(params, cfg, x, positions, kv_valid, causal,
                              cross, cross_valid, remat)
        return params.final_norm(x, cfg.norm_eps), aux
    for layer, cache, ckv in zip(params.layers, caches, cross):
        x = blk.apply_block(layer, x, cfg, mode=mode, cache=cache,
                            positions=positions, pos=pos, kv_valid=kv_valid,
                            rows=rows, chunk=chunk, active=active,
                            causal=causal, cross=ckv,
                            cross_valid=cross_valid)
    return params.final_norm(x, cfg.norm_eps), \
        (None if mode == "full" else caches)


def _train_stack(params: Model, cfg: ModelConfig, x, positions, kv_valid,
                 causal: bool, cross, cross_valid, remat: bool):
    """The decoder layers in mode 'train', the MoE aux carried from 0;
    with ``remat`` each layer is a checkpoint. -> (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, ckv in zip(params.layers, cross):
        def run(x, aux, layer=layer, ckv=ckv):
            return blk.apply_block(layer, x, cfg, mode="train", cache=None,
                                   positions=positions, kv_valid=kv_valid,
                                   causal=causal, cross=ckv,
                                   cross_valid=cross_valid, aux=aux)
        x, aux = checkpoint(run, x, aux, use_reentrant=False) if remat \
            else run(x, aux)
    return x, aux


def _cross_inputs(params: Model, cfg: ModelConfig, batch, mode: str, caches,
                  rows):
    """(each decoder layer's cross (k, v), the frame mask) of an enc-dec
    forward: built from ``batch["enc_embeds"]`` in modes 'full', 'train'
    and 'prefill' (and in 'prefill' written into the caches, then read
    from there), read from the caches in 'decode'."""
    if mode == "decode":
        return [(c["cross_k"], c["cross_v"]) for c in caches], None
    if "enc_embeds" not in batch:
        raise ValueError(f"{cfg.name}: mode {mode!r} needs enc_embeds")
    valid = batch.get("enc_valid")
    if valid is not None:
        valid = valid.to(model_device(params))
    enc = encode(params, cfg, batch["enc_embeds"], valid, mode="train") \
        if mode == "train" else encode(params, cfg, batch["enc_embeds"], valid)
    cross = build_cross_kv(params, cfg, enc)
    if mode == "prefill":
        _write_cross(caches, cross, rows)
        cross = [(c["cross_k"], c["cross_v"]) for c in caches]
    return cross, valid


def head_table(params: Model, cfg: ModelConfig) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.lm_head


def loss_fn(params: Model, cfg: ModelConfig, batch, *, remat: bool = False):
    """Causal-LM loss over ``batch`` ({'tokens' or 'embeds', 'labels'
    (B,S)[, 'loss_mask', 'positions', 'enc_embeds']}) through mode
    'train': (total, {'xent', 'z', 'aux'}), total = xent + 1e-4 z + 1e-2
    aux, the reference's ``loss_fn``."""
    x, aux = forward(params, cfg, batch, mode="train", caches=None,
                     remat=remat)
    mask = batch.get("loss_mask")
    loss, z = vocab_mod.lm_head_loss(
        x, head_table(params, cfg), batch["labels"].to(x.device), cfg,
        None if mask is None else mask.to(x.device))
    total = loss + 1e-4 * z + 1e-2 * aux
    return total, {"xent": loss, "z": z, "aux": aux}


def prefill(params: Model, cfg: ModelConfig, batch, max_len: int,
            kv_valid=None):
    """Run the prompt (tokens, or embeds) into fresh caches; returns (last
    hidden (B,d), caches). An enc-dec batch's ``enc_embeds`` sets the
    caches' encoder frames, and its cross K/V comes back in them."""
    B = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
    enc = batch.get("enc_embeds")
    caches = init_caches(cfg, B, max_len, model_device(params),
                         enc_len=None if enc is None else enc.shape[1])
    x, caches = forward(params, cfg, batch, mode="prefill", caches=caches,
                        kv_valid=kv_valid)
    return x[:, -1], caches


def chunk_prefill_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                       caches, slots, start, write_pos, lengths):
    """Run one prompt chunk per group row against the live caches: tokens
    (P,C) for cache rows ``slots`` (P,) at absolute offsets ``start``
    (P,) — row j covers positions start[j]..start[j]+C-1, of which the
    first ``lengths[j]`` are real (``lengths == 0`` marks a padded group
    row, which writes nothing). K/V is written in place at ``write_pos[j]
    + i`` and queries attend the whole written prefix, so iterating chunks
    is prefix-consistent with a monolithic prefill. ``slots``, ``start``,
    ``write_pos`` and ``lengths`` are host arrays, checked and turned into
    the call's coordinates on the host (``attention.chunk_writes``).
    Returns (hidden (P,C,d), caches)."""
    device = model_device(params)
    max_len, ring = cache_extents(cfg, caches)
    arrays, dequant = attn_mod.chunk_writes(
        slots, start, write_pos, lengths, tokens.shape[1], max_len,
        next(iter(caches[0].values())).shape[0], ring=ring)
    chunk = attn_mod.chunk_coords(
        {k: torch.from_numpy(a).to(device) for k, a in arrays.items()},
        tokens.shape[1], dequant)
    return forward(params, cfg, {"tokens": tokens}, mode="chunk",
                   caches=caches, chunk=chunk)


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                caches, pos, active=None):
    """One decode step: tokens (B,1), or embeds (B,1,d), at per-row
    positions ``pos`` (B,). Returns (last hidden (B,d), caches)."""
    batch = {"tokens": tokens} if tokens.dim() == 2 else {"embeds": tokens}
    x, caches = forward(params, cfg, batch, mode="decode", caches=caches,
                        pos=pos, active=active)
    return x[:, -1], caches


def greedy_next(params: Model, cfg: ModelConfig,
                hidden: torch.Tensor) -> torch.Tensor:
    """hidden (B,d) -> next token ids (B,) int32."""
    return vocab_mod.sharded_greedy(hidden, head_table(params, cfg), cfg)
