"""Encoder-decoder serving (whisper): the JAX package's enc-dec prefill and
decode cells (``repro/launch/specs.py``, ``prefill_*`` and ``decode_*``),
run for real on the port.

A batch is ``batch_size`` rows, each the encoder frames of one 30-second
window (stub embeddings: the conv frontend is a stub in the reference) and
a prompt of up to ``prompt_len`` tokens (the start-of-transcript sequence),
right-padded. Two stages of the executor serve it, each a CUDA graph on the
card, captured after its first (eager) call, as the reference jits them:

- ``("encdec_prefill", B)``: the encoder, each decoder layer's cross K/V
  built from its output and written into the server's cross buffers, the
  decoder's prefill into its self caches, and the greedy token after each
  row's last real prompt token;
- ``("encdec_decode", B)``: one decode step of every row at its own
  position (self-attention over its cache, cross-attention over every
  frame) and the greedy token.

Both stages read and write one set of caches that the server allocates
once (``model.init_caches``): a captured graph holds their addresses, so
a prefill writes a new batch's cross K/V into the same buffers (in place)
and never rebinds them. Decoding is greedy for a fixed number of tokens
and ignores any end token (the weights are random).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.whisper_medium import ENC_FRAMES
from repro_torch.models import model as model_mod
from repro_torch.models.common import dtype_of
from repro_torch.serving.executor import StageExecutor, StaticStage
from repro_torch.serving.telemetry import percentile

# the prompt lengths a batch's rows take in turn: Whisper's
# start-of-transcript sequence is 4 tokens, the reference's prefill cell
# gives 16, and the rows between exercise the right-padding
PROMPT_LENS = (16, 4, 9, 4, 12, 4, 7, 4)


def stub_batch(cfg: ModelConfig, batch: int, seed: int,
               frames: int = ENC_FRAMES):
    """One batch's inputs from a seeded numpy generator: stub frame
    embeddings (batch, frames, d_model) f32, N(0,1) x 0.1 (as
    ``tests/test_arch_smoke.py`` draws them), and prompts of random token
    ids of ``PROMPT_LENS`` lengths in turn."""
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((batch, frames, cfg.d_model),
                              dtype=np.float32) * np.float32(0.1)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LENS[i % len(
        PROMPT_LENS)]).astype(np.int32) for i in range(batch)]
    return enc, prompts


@dataclass
class TranscribeRun:
    """One batch: the new tokens (B, n) in row order, the prefill call's
    and each decode step's wall seconds (a stage call to completion, its
    tokens copied to the host), and the batch's wall seconds."""
    tokens: np.ndarray
    prefill_s: float
    step_s: List[float]
    wall_s: float

    def report(self) -> str:
        B, n = self.tokens.shape
        s = sorted(x * 1e3 for x in self.step_s)
        return (f"{B} rows x {n} new tokens in {self.wall_s:.4f} s: "
                f"{B * n / self.wall_s:.1f} new tokens/s; encoder + "
                f"prefill call {self.prefill_s * 1e3:.3f} ms; decode step "
                f"p50 {percentile(s, 0.5):.3f} ms p99 "
                f"{percentile(s, 0.99):.3f} ms over {len(s)} steps")


class EncDecServer:
    """Serves an enc-dec config in batches of ``batch_size`` rows of
    ``enc_frames`` frames and prompts of at most ``prompt_len`` tokens,
    decoding into self caches of ``max_len`` positions (default the
    config's ``max_target_len``). ``cuda_graphs=False`` runs both stages
    eagerly on the card."""

    def __init__(self, cfg: ModelConfig, params: model_mod.Model, *,
                 batch_size: int = 8, enc_frames: int = ENC_FRAMES,
                 prompt_len: int = max(PROMPT_LENS),
                 max_len: Optional[int] = None,
                 cuda_graphs: bool = True):
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg, self.params = cfg, params
        self.batch_size, self.enc_frames = batch_size, enc_frames
        self.prompt_len = prompt_len
        self.max_len = max_len or cfg.encdec.max_target_len
        self.device = model_mod.model_device(params)
        self.executor = StageExecutor(
            graphs=cuda_graphs and self.device.type == "cuda")
        # the one set of caches both stages read and write, in place
        self.caches = model_mod.init_caches(cfg, batch_size, self.max_len,
                                            self.device, enc_len=enc_frames)

    def prefill_stage(self) -> StaticStage:
        """Buffers ``enc_embeds`` (B, T, d) in the activation dtype,
        ``tokens`` (B, P) int32 and ``kv_valid`` (B, P) bool; the body
        returns each row's first new token (B,) int32."""
        B, T, P, dev = (self.batch_size, self.enc_frames, self.prompt_len,
                        self.device)
        cfg, params = self.cfg, self.params

        def buffers(_variant):
            return {"enc_embeds": torch.zeros(
                        (B, T, cfg.d_model), device=dev,
                        dtype=dtype_of(cfg.activation_dtype)),
                    "tokens": torch.zeros((B, P), dtype=torch.int32,
                                          device=dev),
                    "kv_valid": torch.zeros((B, P), dtype=torch.bool,
                                            device=dev)}

        def body(buf, _variant):
            x, _ = model_mod.forward(
                params, cfg, {"tokens": buf["tokens"],
                              "enc_embeds": buf["enc_embeds"]},
                mode="prefill", caches=self.caches, kv_valid=buf["kv_valid"])
            last = (buf["kv_valid"].sum(-1) - 1).clamp(min=0)
            h = x[torch.arange(B, device=dev), last]
            return model_mod.greedy_next(params, cfg, h)

        return StaticStage(buffers, body)

    def decode_stage(self) -> StaticStage:
        """Buffers ``tokens`` (B, 1) int32 and ``pos`` (B,) int32; the body
        returns each row's next token (B,) int32."""
        B, dev = self.batch_size, self.device
        cfg, params = self.cfg, self.params

        def buffers(_variant):
            return {"tokens": torch.zeros((B, 1), dtype=torch.int32,
                                          device=dev),
                    "pos": torch.zeros(B, dtype=torch.int32, device=dev)}

        def body(buf, _variant):
            h, _ = model_mod.decode_step(params, cfg, buf["tokens"],
                                         self.caches, buf["pos"])
            return model_mod.greedy_next(params, cfg, h)

        return StaticStage(buffers, body)

    def transcribe(self, enc_embeds: np.ndarray,
                   prompts: Sequence[np.ndarray],
                   new_tokens: int) -> TranscribeRun:
        """One batch of exactly ``batch_size`` rows: frame embeddings
        (B, T, d) and prompts of 1..P tokens -> ``new_tokens`` greedy
        tokens a row (the prefill's, then one decode step each)."""
        B, P = self.batch_size, self.prompt_len
        lens = np.array([len(p) for p in prompts], np.int32)
        if len(prompts) != B or enc_embeds.shape != (B, self.enc_frames,
                                                     self.cfg.d_model):
            raise ValueError(f"a batch is {B} rows of {self.enc_frames} "
                             f"frames; got {len(prompts)} prompts and "
                             f"frames {enc_embeds.shape}")
        if not (1 <= lens.min() and lens.max() <= P) or new_tokens < 1 \
                or lens.max() + new_tokens > self.max_len:
            raise ValueError(f"prompts of 1..{P} tokens and {new_tokens} "
                             f"new tokens must fit {self.max_len} positions; "
                             f"got lengths {lens.tolist()}")
        tokens = np.zeros((B, P), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        valid = np.arange(P)[None, :] < lens[:, None]
        dt = dtype_of(self.cfg.activation_dtype)
        ex = self.executor
        out = np.zeros((B, new_tokens), np.int32)
        t0 = time.perf_counter()
        out[:, 0] = ex.dispatch(
            "encdec_prefill", B, self.prefill_stage,
            {"enc_embeds": torch.from_numpy(enc_embeds).to(dt),
             "tokens": tokens, "kv_valid": valid})
        prefill_s = time.perf_counter() - t0
        step_s = []
        for i in range(1, new_tokens):
            t = time.perf_counter()
            out[:, i] = ex.dispatch(
                "encdec_decode", B, self.decode_stage,
                {"tokens": out[:, i - 1:i], "pos": lens + (i - 1)})
            step_s.append(time.perf_counter() - t)
        return TranscribeRun(out, prefill_s, step_s,
                             time.perf_counter() - t0)
