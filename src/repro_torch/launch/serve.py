"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch
deepseek-7b --requests 16`` (or ``--arch gemma2-27b``, local and global
layers in turn; or ``--arch gemma-2b``, MQA at head_dim 256 with padded
heads; or ``--arch recurrentgemma-9b``, two RG-LRU recurrent blocks to each
local one; or ``--arch qwen2-vl-7b``, M-RoPE, q/k/v biases and 28 query
heads padded to 32, served on token prompts at its default (t, h, w)
positions, as the JAX engine serves it; or ``--arch mamba2-130m``, Mamba2
SSD mixer blocks alone, whose per-slot state is constant in the context
length, on no CUDA kernel: its path has no attention and, with
``--precision w8a8``, zero int8 sites; or ``--arch dbrx-132b``, global
attention at G 6 whose MLP half is a mixture of 16 experts, top 4, with
capacity drops, and whose w8a8 build quantizes the attention projections
alone; or ``--arch command-r-plus-104b``, global attention at G 12 with
LayerNorm; or ``--arch kimi-k2-1t-a32b``, global attention at G 8 whose
MLP half is a mixture of 384 experts, top 8, padded to 512) —
continuous-batching LM serving
with bucketed batched prefill on the card (``--device cpu`` runs the
plain versions of the kernels on the host). ``--smoke`` (the default) serves the reduced
config; ``--full-config`` the published widths, refused before anything
is allocated when the weights alone pass the card's memory (dbrx-132b's
~264 GB, command-r-plus-104b's ~208 GB, kimi-k2-1t-a32b's ~2.8 TB: the
message names the ``chip_smoke.py`` phase that serves a cut of the arch's
layers at full width instead, ``CARD_CUTS``). The request trace is the
JAX launcher's: the same seeded generator, lengths and priorities.
``--arch dlrm`` serves the 4-stage DLRM pipeline on a row-wise int8 slab
(batches of 64 from ``dlrm_batches``, a full-trace warm-up first);
``--full-config`` is ``PAPER_COMPLEX`` with halved tables on one shard, the
size one 80 GB card holds.
``--arch xlmr-paper`` serves the paper's XLM-R encoder (``serve_encoder``):
``--requests`` sentences from ``xlmr_sentences``, length-sorted into
batches of ``--slots`` rows, each batch padded to its length bucket (32 ..
512) and encoded by that bucket's stage (one CUDA graph per bucket on the
card) into mean-pooled embeddings; it prints the naive and the sorted
batching's padding waste, sentences/s, real tokens/s, the latency by
bucket, the graphs captured and the peak memory.
``--arch whisper-medium`` transcribes (``serve_encdec``): batches of
``--slots`` rows, each 1500 stub frame embeddings and a 4-16 token prompt,
``--new-tokens`` greedy tokens a row through the encoder + prefill stage
and the decode stage (``serving/encdec.py``, one CUDA graph each on the
card): a warm-up batch, then a timed one; it prints the encoder + prefill
call, decode step p50/p99, new tokens/s, the graphs captured and the peak
memory.
``--precision w8a8`` serves the calibrated int8 path (the §V build step,
then the w8a8 kernel for every int8 site); ``--verify-quant`` replays the
trace on an unquantized engine and exits non-zero when the greedy-token
agreement falls below the 0.90 guardrail. One w8a8 engine's build moves
the int8 sites' fp weights to the host (``release_fp``), so the fp and int8
models are never on the device together (gemma2-27b's would not fit one
80 GB card); ``--verify-quant`` serves its fp reference before the build.
``--prefill-chunk N`` splits prompts into N-token chunks interleaved with
decode steps; ``--verify-chunked`` replays the trace monolithically and
exits non-zero unless every output is token-identical. ``--prefix-cache N``
(with ``--prefill-chunk``) caches prompt prefixes at chunk granularity;
``--verify-prefix`` replays a hot-system-prompt trace through the warm
cache and exits non-zero unless it hits and every output is
token-identical to a cold engine's.

The fleet: ``--replicas N`` fronts N engine replicas with the
``ReplicaRouter`` (``--route count|feedback``, ``--steal``); on the card the
replicas share the one device and step in turn on one stream, so every
fleet time includes the siblings' compute. ``--verify-steal`` hot-spots the
trace onto replica 0, drains it mid-run and exits non-zero unless work was
stolen and nothing was lost. ``--replica-precisions fp32,w8a8`` serves a
mixed fleet (the quantized weights built once); with ``--verify-quant`` it
checks that every class-0 request landed on fp32. ``--verify-fleet-prefix``
serves the hot-system-prompt trace through the fleet-shared prefix tier
and checks remote hits, nothing lost and token identity with a cold
engine. ``--prefill-chunk auto`` picks the chunk at the performance
model's efficiency knee; ``--verify-autotune`` first fits the model from
this run's own replayed chunk calls, then checks the chunk is on the
ladder, at or below the fitted knee and token-identical to chunk 16.
``--elastic-smoke`` runs the elastic controller on the fleet simulator
(no model, no device). ``--service-ms-est`` turns on feasibility shedding.
The encoder and encoder-decoder paths refuse the LM engine's flags
(``LM_ONLY_FLAGS``) rather than serve without them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import dlrm_paper, get_config, reduce_for_smoke
from repro_torch.configs.xlmr_paper import SEQ_BUCKETS
from repro_torch.core.bucketing import length_sorted_batches
from repro_torch.core.metrics import token_agreement
from repro_torch.data.synthetic import dlrm_batches, xlmr_sentences
from repro_torch.kernels import _build
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import model as model_mod
from repro_torch.models.quantize import build_quantized_params
from repro_torch.serving.dlrm_engine import DLRMEngine
from repro_torch.serving.dlrm_engine import make_replicas as dlrm_replicas
from repro_torch.serving.encdec import EncDecServer, stub_batch
from repro_torch.serving.encoder import (EncoderServer, arrival_batches,
                                         padding_waste)
from repro_torch.serving.engine import InferenceEngine, Request, make_replicas
from repro_torch.serving.perf_model import PerfModel
from repro_torch.serving.router import ReplicaRouter

# one H100's memory: the card a ``--full-config`` model must fit when the
# launcher serves on the host (on the card, the card's own)
CARD_BYTES = 80e9
# the archs whose weights pass one card: the chip_smoke.py phase that
# serves the first layers of each at full width instead, and how many
CARD_CUTS = {"dbrx-132b": ("serve-dbrx", 8),
             "command-r-plus-104b": ("serve-cmdr", 16),
             "kimi-k2-1t-a32b": ("serve-kimi", 1)}

# the JAX launcher's greedy-token-agreement guardrail for w8a8 serving
QUANT_AGREEMENT_THRESHOLD = 0.90

# the hand-set chunk the autotune check must be token-identical to
AUTOTUNE_REF_CHUNK = 16
# prompt lengths of the autotune calibration: one per chunk bucket of a
# chunk-128 engine (16, 32, 64, 128), each served once to warm its stage
# key and then CALIBRATION_PASSES times
CALIBRATION_LENGTHS = (12, 30, 60, 120)
CALIBRATION_PASSES = 3


def _lm_requests(args, cfg):
    rng = np.random.default_rng(7)
    lens = np.clip(rng.lognormal(3.0, 0.7, args.requests).astype(int), 3,
                   args.max_len // 2)
    # with the priority policy, tag ~1/4 of traffic latency-critical
    # (class 0) and the rest batch (class 1)
    prios = (rng.integers(0, 4, args.requests) == 0).astype(int) ^ 1 \
        if args.policy == "priority" else np.zeros(args.requests, int)
    return [Request(i, rng.integers(0, cfg.vocab_size, l).astype(np.int32),
                    max_new_tokens=args.new_tokens, priority=int(p))
            for i, (l, p) in enumerate(zip(lens, prios))]


def _prefix_requests(args, cfg):
    """Hot-system-prompt trace (the JAX launcher's): every request opens
    with the same 3-chunk prefix and ends with a short suffix of its
    own."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size,
                          3 * args.prefill_chunk).astype(np.int32)
    reqs = []
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 12))).astype(np.int32)
        reqs.append(Request(i, np.concatenate([prefix, tail]),
                            max_new_tokens=args.new_tokens))
    return reqs


def autotune_model(cfg, params, kw, precision="fp32",
                   lengths=CALIBRATION_LENGTHS):
    """(PerfModel, calibration ladder): a model fitted from this process's
    own stage calls. A chunked engine whose chunk is the top bucket serves
    one request per length of ``lengths`` (each lands in its own chunk
    bucket), once to warm the key up and CALIBRATION_PASSES more times; the model
    is fitted from those replayed chunk calls (and the decode steps)
    alone (``InferenceEngine.observe_stages``)."""
    top = max(b for b in kw["prefill_buckets"] if b <= kw["max_len"])
    eng = InferenceEngine(cfg, params, precision=precision,
                          **dict(kw, prefill_chunk=top, prefix_cache=None,
                                 perf_model=None))
    rng = np.random.default_rng(5)
    for k in range(CALIBRATION_PASSES + 1):
        for i, n in enumerate(lengths):
            eng.run([Request(1000 * k + i,
                             rng.integers(0, cfg.vocab_size, n)
                             .astype(np.int32),
                             max_new_tokens=1)])
    pm = eng.observe_stages(PerfModel.for_params(params))
    return pm, eng.chunk_buckets


def _verify_prefix(args, cfg, params, kw):
    """Populate the prefix cache with the hot-system-prompt trace, replay
    it through the warm cache, and exit non-zero unless it hits and every
    replayed output is token-identical to a cold engine's."""
    if not args.prefix_cache:
        raise SystemExit("--verify-prefix needs --prefix-cache")
    warm = InferenceEngine(cfg, params, precision=args.precision, **kw)
    warm.run(_prefix_requests(args, cfg))       # populate pass
    warm.telemetry.reset_serving_stats()
    hot = _prefix_requests(args, cfg)
    warm.run(hot)                               # replay: every prefix hits
    tel = warm.telemetry
    cold = InferenceEngine(cfg, params, precision=args.precision,
                           **dict(kw, prefix_cache=None))
    ref = _prefix_requests(args, cfg)
    cold.run(ref)
    bad = [r.rid for r, m in zip(hot, ref) if r.output != m.output]
    if bad:
        raise SystemExit(f"FAIL: cache-hit outputs diverge from cold "
                         f"prefill for requests {bad}")
    if tel.prefix_hits == 0:
        raise SystemExit("FAIL: no prefix hits on a replayed "
                         "hot-system-prompt trace")
    print(f"verify-prefix OK: {len(hot)} requests replayed, "
          f"{tel.prefix_hits} prefix-cache hits, outputs token-identical "
          f"to cold prefill")
    print(tel.report())
    return tel


def refuse_oversize(cfg, device) -> None:
    """Raise ``SystemExit`` before any allocation when ``cfg``'s weights
    alone pass the card's memory (counted on the meta device)."""
    meta = model_mod.Model(cfg, None, "meta")
    nbytes = sum(t.numel() * t.element_size() for t in meta.parameters())
    device = torch.device(device)
    card = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else CARD_BYTES)
    if nbytes > card:
        cut = ""
        if cfg.name in CARD_CUTS:
            phase, layers = CARD_CUTS[cfg.name]
            cut = (f" (chip_smoke.py's {phase} phase serves {cfg.name}'s "
                   f"first {layers} of {cfg.num_layers} layers at full width "
                   f"on one card)")
        raise SystemExit(
            f"--full-config {cfg.name}: its {cfg.num_layers} layers' "
            f"weights take {nbytes / 1e9:.1f} GB in {cfg.param_dtype}, past "
            f"the card's {card / 1e9:.1f} GB{cut}")


def serve_lm(args):
    cfg = reduce_for_smoke(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    if not args.smoke:
        refuse_oversize(cfg, args.device)
    if torch.device(args.device).type == "cuda":
        # set-up, not serving: without this the first prefill call would
        # compile the kernels inside the first requests' TTFT
        t0 = time.perf_counter()
        _build.build_all()
        print(f"CUDA kernels built in {time.perf_counter() - t0:.1f}s")
    if args.verify_chunked and not args.prefill_chunk:
        raise SystemExit("--verify-chunked needs --prefill-chunk")
    if args.prefix_cache and not args.prefill_chunk:
        raise SystemExit("--prefix-cache needs --prefill-chunk")
    params = model_mod.init_params(cfg, seed=0, device=args.device)
    kw = dict(batch_slots=args.slots, max_len=args.max_len,
              prefill_buckets=(16, 32, 64, 128), policy=args.policy,
              slo_ms=args.slo_ms, max_queue=args.max_queue,
              service_ms_est=args.service_ms_est,
              prefill_chunk=args.prefill_chunk,
              prefix_cache=args.prefix_cache, device=args.device)
    if args.verify_prefix:
        if args.replicas > 1:
            raise SystemExit("--verify-prefix runs single-engine only "
                             "(drop --replicas)")
        return _verify_prefix(args, cfg, params, kw)
    if args.verify_fleet_prefix:
        return _verify_fleet_prefix(args, cfg, params, kw)
    reqs = _lm_requests(args, cfg)
    if args.replicas > 1:
        if args.verify_chunked:
            raise SystemExit("--verify-chunked runs single-engine only "
                             "(drop --replicas)")
        if args.verify_autotune:
            raise SystemExit("--verify-autotune runs single-engine only "
                             "(drop --replicas)")
        precisions = [p.strip() for p in args.replica_precisions.split(",")] \
            if args.replica_precisions \
            else [args.precision] * args.replicas
        if args.verify_quant and len(set(precisions)) < 2:
            raise SystemExit("--verify-quant with --replicas needs a mixed "
                             "--replica-precisions fleet (e.g. fp32,w8a8)")
        router = ReplicaRouter(make_replicas(cfg, params, args.replicas,
                                             precisions=precisions, **kw),
                               route=args.route, steal=args.steal)
        if args.verify_steal:
            return _verify_steal(router, reqs, args)
        if args.verify_quant:
            return _verify_quant_fleet(router, reqs, args)
        t0 = time.perf_counter()
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        tel = router.fleet_telemetry()
        wall = time.perf_counter() - t0
        print(f"fleet served {tel.served} requests in {wall:.2f}s on "
              f"{args.device} across {args.replicas} replicas "
              f"(routed {router.routed}, shed {router.shed})")
        print(router.report())
        return tel
    if args.verify_steal:
        raise SystemExit("--verify-steal needs --replicas >= 2 --steal")
    if args.replica_precisions:
        raise SystemExit("--replica-precisions needs --replicas >= 2")
    if args.verify_quant and args.precision != "w8a8":
        raise SystemExit("--verify-quant needs --precision w8a8 "
                         "(or a mixed --replica-precisions fleet)")
    ref_reqs = None
    if args.precision == "w8a8":
        if args.verify_quant:
            # the fp reference serves first: the build below moves the int8
            # sites' fp weights to the host, after which no fp engine can
            # serve ``params``
            ref_reqs = InferenceEngine(cfg, params, precision="fp32",
                                       **kw).run(_lm_requests(args, cfg))
        t0 = time.perf_counter()
        quant = build_quantized_params(cfg, params, release_fp=True)
        kw["quantized_params"] = quant
        print(f"w8a8 build step in {time.perf_counter() - t0:.2f}s: "
              f"{quant.quantized_sites} sites int8 (their fp weights moved "
              f"to the host), {quant.fallback_sites} fp fallbacks")
    fitted_knee = None
    if args.verify_autotune:
        if args.prefill_chunk != "auto":
            raise SystemExit("--verify-autotune needs --prefill-chunk auto")
        t0 = time.perf_counter()
        pm, ladder = autotune_model(cfg, params, kw, args.precision)
        fitted_knee = pm.suggest_prefill_chunk(ladder)
        kw["perf_model"] = pm
        print(f"autotune: fitted {pm.fitted_terms()} from this run's "
              f"replayed calls in {time.perf_counter() - t0:.2f}s; knee "
              f"{fitted_knee} on {ladder}")
    eng = InferenceEngine(cfg, params, precision=args.precision, **kw)
    t0 = time.perf_counter()
    eng.run(reqs)
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    chunked = (f", {tel.continuations} chunk continuations"
               if args.prefill_chunk else "")
    print(f"served {tel.served} requests in {wall:.2f}s on {args.device} "
          f"({tel.total_tokens / wall:.0f} tok/s, {tel.steps} decode steps, "
          f"{tel.prefills} prefills in {tel.prefill_batches} batched "
          f"dispatches{chunked})")
    print(tel.report())
    if args.verify_chunked:
        ref = InferenceEngine(cfg, params, precision=args.precision,
                              **dict(kw, prefill_chunk=None))
        ref_reqs = _lm_requests(args, cfg)
        ref.run(ref_reqs)
        bad = [r.rid for r, m in zip(reqs, ref_reqs) if r.output != m.output]
        if bad:
            raise SystemExit(f"FAIL: chunked outputs diverge from "
                             f"monolithic for requests {bad}")
        print(f"verify-chunked OK: {len(reqs)} requests token-identical "
              f"to monolithic prefill")
    if args.verify_autotune:
        chosen = eng.prefill_chunk
        if chosen not in eng.buckets:
            raise SystemExit(f"FAIL: auto chunk {chosen} is not on the "
                             f"bucket ladder {eng.buckets}")
        if chosen > fitted_knee:
            raise SystemExit(f"FAIL: auto chunk {chosen} above the fitted "
                             f"efficiency knee {fitted_knee}")
        ref = InferenceEngine(cfg, params, precision=args.precision,
                              **dict(kw, perf_model=None,
                                     prefill_chunk=AUTOTUNE_REF_CHUNK))
        ref_reqs = _lm_requests(args, cfg)
        ref.run(ref_reqs)
        bad = [r.rid for r, m in zip(reqs, ref_reqs)
               if r.output != m.output]
        if bad:
            raise SystemExit(f"FAIL: auto-chunk outputs diverge from the "
                             f"hand-set chunk {AUTOTUNE_REF_CHUNK} for "
                             f"requests {bad}")
        print(f"verify-autotune OK: auto chunk {chosen} on ladder "
              f"{eng.buckets} (<= fitted knee {fitted_knee}); {len(reqs)} "
              f"requests token-identical to hand-set chunk "
              f"{AUTOTUNE_REF_CHUNK}")
    if args.verify_quant:
        agreement = token_agreement([(r.output, m.output)
                                     for r, m in zip(reqs, ref_reqs)])
        if agreement < QUANT_AGREEMENT_THRESHOLD:
            raise SystemExit(
                f"FAIL: w8a8 greedy-token agreement {agreement:.3f} below "
                f"the {QUANT_AGREEMENT_THRESHOLD} guardrail")
        q = eng.quant
        print(f"verify-quant OK: {len(reqs)} requests, token agreement "
              f"{agreement:.3f} >= {QUANT_AGREEMENT_THRESHOLD} vs fp "
              f"({q.quantized_sites} sites int8, {q.fallback_sites} "
              f"fp fallbacks, calib disagreement "
              f"{q.result.metric_delta:.4f})")
    return tel


def _verify_fleet_prefix(args, cfg, params, kw):
    """A multi-replica fleet with the fleet-shared prefix tier under the
    hot-system-prompt trace: a populate pass lands the shared prefix on
    one replica, the rest of the trace routes through the steering path
    and must produce remote hits (steered or shipped), lose nothing and
    stay token-identical to a cold single engine. Exits non-zero on any
    violation."""
    if args.replicas < 2:
        raise SystemExit("--verify-fleet-prefix needs --replicas >= 2")
    if not args.prefix_cache:
        raise SystemExit("--verify-fleet-prefix needs --prefix-cache")
    pm = PerfModel.for_params(params)
    reqs = _prefix_requests(args, cfg)
    router = ReplicaRouter(make_replicas(cfg, params, args.replicas,
                                         precisions=[args.precision]
                                         * args.replicas, **kw),
                           route=args.route, steal=args.steal,
                           perf_model=pm, fleet_prefix=True,
                           prefix_host_entries=4 * args.prefix_cache)
    # populate pass: the first request warms ONE replica's cache and
    # registers it in the fleet index
    router.submit(reqs[0])
    router.run_until_drained()
    for r in reqs[1:]:
        router.submit(r)
    router.run_until_drained()
    tel = router.fleet_telemetry()
    lost = [r.rid for r in reqs if not r.done]
    if lost:
        raise SystemExit(f"FAIL: fleet-prefix run lost requests {lost}")
    cold = InferenceEngine(cfg, params, precision=args.precision,
                           **dict(kw, prefix_cache=None))
    ref = _prefix_requests(args, cfg)
    cold.run(ref)
    bad = [r.rid for r, m in zip(reqs, ref) if r.output != m.output]
    if bad:
        raise SystemExit(f"FAIL: fleet-prefix outputs diverge from cold "
                         f"prefill for requests {bad}")
    if tel.prefix_remote_hits == 0:
        raise SystemExit("FAIL: no remote prefix hits on a hot-system-"
                         "prompt trace across the fleet")
    if tel.prefix_hits == 0:
        raise SystemExit("FAIL: no prefix-cache hits after steering")
    print(f"verify-fleet-prefix OK: {len(reqs)} requests across "
          f"{args.replicas} replicas (routed {router.routed}), "
          f"{tel.prefix_remote_hits} remote hits "
          f"({tel.prefix_shipped} shipped, {tel.prefix_recomputed} "
          f"priced-out recomputes, {tel.prefix_host_hits} host-tier "
          f"fault-ins), {tel.prefix_hits} local hits, 0 lost, outputs "
          f"token-identical to cold prefill")
    print(router.report())
    return tel


def _verify_quant_fleet(router, reqs, args):
    """A mixed fp32 + w8a8 fleet under the priority policy must route
    every class-0 request to an fp32 replica while one is live, lose
    nothing and count no precision downgrade. Exits non-zero on any
    violation."""
    if not any(r.priority == 0 for r in reqs):
        raise SystemExit("FAIL: trace has no class-0 requests — the pin "
                         "check would be vacuous (use --policy priority "
                         "and enough --requests)")
    misrouted = []
    for r in reqs:
        before = list(router.routed)
        router.submit(r)
        j = next(i for i in range(len(router.replicas))
                 if router.routed[i] != before[i])
        if r.priority == 0 and router.precisions[j] != "fp32":
            misrouted.append(r.rid)
    router.run_until_drained()
    tel = router.fleet_telemetry()
    lost = [r.rid for r in reqs if not r.done]
    if lost:
        raise SystemExit(f"FAIL: mixed-precision fleet lost requests "
                         f"{lost}")
    if misrouted:
        raise SystemExit(f"FAIL: class-0 requests {misrouted} routed to "
                         f"an int8 replica while fp32 was live")
    if tel.precision_rehomed:
        raise SystemExit(f"FAIL: {tel.precision_rehomed} precision "
                         f"downgrades counted with fp32 live throughout")
    high = sum(r.priority == 0 for r in reqs)
    print(f"verify-quant OK: mixed fleet {router.precisions} served "
          f"{tel.served} requests (routed {router.routed}), all {high} "
          f"class-0 on fp32, 0 lost, 0 downgrades")
    print(router.report())
    return tel


def drive_steal(router, reqs, drain_at=2):
    """Hot-spot every request onto replica 0 (bypassing the balancer) and
    drive the fleet in steal rounds, one step per live replica a round;
    replica 0 is drained after round ``drain_at``."""
    for r in reqs:
        router.replicas[0].submit(r)
    rounds = 0
    while router.has_work:
        router.maybe_steal()
        for i, rep in enumerate(router.replicas):
            if not router.dead[i] and rep.has_work:
                rep.step_once()
        rounds += 1
        if rounds == drain_at:
            router.drain_replica(0)         # the replica dies mid-run
    return router.fleet_telemetry()


def _verify_steal(router, reqs, args):
    """A hot-keyed stream lands every request on replica 0, so only
    stealing puts the siblings to work; replica 0 is then drained mid-run
    and its outstanding load must move to the survivors with none lost.
    Exits non-zero on any violation."""
    if not args.steal:
        raise SystemExit("--verify-steal needs --steal")
    tel = drive_steal(router, reqs)
    lost = [r.rid for r in reqs if not r.done]
    if lost:
        raise SystemExit(f"FAIL: fault drain lost requests {lost}")
    if tel.steals == 0:
        raise SystemExit("FAIL: no steals under a hot-keyed stream")
    if tel.drained == 0:
        raise SystemExit("FAIL: mid-run kill drained nothing")
    print(f"verify-steal OK: {len(reqs)} requests, {tel.steals} stolen, "
          f"{tel.drained} re-homed by the kill, 0 lost")
    print(router.report())
    return tel


def elastic_smoke():
    """The elastic scenario on the deterministic fleet simulator: a flash
    crowd with a FleetController in the loop and a replica frozen
    mid-crowd. Checks scale-up under the crowd, scale-down through the
    trough, exactly one missed-heartbeat fault drain, nothing lost, and
    both wins over the fixed fleet (less shedding, fewer replica-seconds).
    Exits non-zero on any violation. Virtual clock: no model, no device."""
    from repro_torch.serving.fleet_sim import elastic_vs_fixed
    r = elastic_vs_fixed(kill_at_frac=0.33)
    ctl, el = r["controller"], r["elastic"]
    checks = [
        (ctl.scale_ups >= 1, "no scale-up under the flash crowd"),
        (ctl.scale_downs >= 1, "no scale-down through the trough"),
        (ctl.faults_drained == 1,
         f"expected exactly 1 fault drain, got {ctl.faults_drained}"),
        (r["zero_lost"], f"lost tickets: elastic {el['lost']}, "
                         f"fixed {r['fixed']['lost']}"),
        (r["shed_improved"], f"elastic shed {el['shed']} not below "
                             f"fixed {r['fixed']['shed']}"),
        (r["capacity_improved"],
         f"elastic burned {r['replica_seconds_elastic']:.1f} replica-s "
         f"vs fixed {r['replica_seconds_fixed']:.1f}"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise SystemExit("FAIL: elastic smoke: " + "; ".join(bad))
    print(f"elastic-smoke OK: {el['completed']} served, shed "
          f"{el['shed']} (fixed {r['fixed']['shed']}), "
          f"{r['replica_seconds_elastic']:.1f} replica-s "
          f"(fixed {r['replica_seconds_fixed']:.1f}), +{ctl.scale_ups} "
          f"up / -{ctl.scale_downs} down / {ctl.faults_drained} fault "
          f"drain, 0 lost")
    print(ctl.report())
    return ctl


def serve_dlrm(args):
    cfg = dlrm_paper.reduce_for_smoke(dlrm_paper.PAPER_COMPLEX) if args.smoke \
        else dlrm_paper.PAPER_COMPLEX_ONE_CARD
    if torch.device(args.device).type == "cuda":
        t0 = time.perf_counter()
        _build.build_all()
        print(f"CUDA kernels built in {time.perf_counter() - t0:.1f}s")
    asn = dlrm_mod.make_assignment(cfg, 1)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = dlrm_mod.init_dlrm(cfg, asn, gen, args.device, quantize=True)
    kw = dict(policy=args.policy, slo_ms=args.slo_ms,
              max_queue=args.max_queue, service_ms_est=args.service_ms_est,
              device=args.device)
    batches = [next(dlrm_batches(cfg, 64, seed=s))
               for s in range(args.requests)]
    if args.replicas > 1:
        # the replicas share one slab (one copy of the tables on the card)
        router = ReplicaRouter(dlrm_replicas(cfg, asn, params,
                                             args.replicas, **kw),
                               route=args.route, steal=args.steal)
        # full-trace warm-up per replica, excluded from latency and
        # transfer stats
        for rep in router.replicas:
            rep.serve(batches, pipelined=True, warm=True)
            rep.telemetry.reset_serving_stats()
        for b in batches:
            router.submit(b)
        router.run_until_drained()
        tel = router.fleet_telemetry()
        print(f"fleet served {tel.served} batches x64 on {args.device} "
              f"across {args.replicas} replicas (routed {router.routed}, "
              f"shed {router.shed})")
        print(router.report())
        return tel
    eng = DLRMEngine(cfg, asn, params, **kw)
    # full-trace warm-up (first calls of every stage), excluded from
    # latency + transfer stats, as the JAX launcher does
    eng.serve(batches, pipelined=True, warm=True)
    _, stats = eng.serve(batches, pipelined=True)
    tel = eng.telemetry
    print(f"served {stats.num_requests} batches x64 on {args.device} "
          f"({stats.qps * 64:.0f} items/s); transfers saved "
          f"{eng.transfer_stats.bytes_saved_frac*100:.0f}% bytes")
    print(tel.report())
    return tel


def serve_encoder(args):
    """The encoder half of ``examples/serve_lm_bucketed.py`` on the port:
    the sorted batches are served once to build (and on the card capture)
    each bucket's stage, then again, timed. Returns (the ``EncoderServer``,
    the timed ``EncodeRun``). Refuses the LM engine's flags
    (``refuse_lm_flags``)."""
    refuse_lm_flags(args, "serve_encoder")
    cfg = reduce_for_smoke(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"CUDA kernels built in {time.perf_counter() - t0:.1f}s")
    params = model_mod.init_params(cfg, seed=0, device=args.device)
    sents = xlmr_sentences(cfg.vocab_size, args.requests, seed=0, min_len=4,
                           max_len=SEQ_BUCKETS[-1])
    lengths = [len(s) for s in sents]
    naive = arrival_batches(len(sents), args.slots)
    batches = length_sorted_batches(lengths, args.slots)
    waste = [padding_waste(lengths, b, SEQ_BUCKETS) * 100
             for b in (naive, batches)]
    print(f"{len(sents)} sentences, lengths {min(lengths)}..{max(lengths)}; "
          f"padding waste: naive batching {waste[0]:.1f}% -> length-sorted "
          f"{waste[1]:.1f}%")
    srv = EncoderServer(cfg, params, batch_size=args.slots,
                        buckets=SEQ_BUCKETS)
    warm = srv.serve(sents, batches)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = srv.serve(sents, batches)
    if not np.isfinite(run.embeds).all():
        raise SystemExit("serve_encoder: non-finite pooled embeddings")
    print(f"served {len(sents)} sentences on {args.device} "
          f"({cfg.name}, d_model {cfg.d_model}) through "
          f"{srv.exe.compile_count} buckets "
          f"(graphs captured {sum(srv.executor.captures.values())}); "
          f"first pass {warm.wall_s:.3f} s")
    print(run.report())
    if cuda:
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
    return srv, run


def serve_encdec(args):
    """The reference's enc-dec prefill and decode cells served for real:
    ``--slots`` rows of ``stub_batch`` (1500 frames, prompts of 4-16
    tokens), ``--new-tokens`` greedy tokens a row, through the two stages
    of ``EncDecServer``; a warm-up batch (seed 0: each stage's first call
    and, on the card, its capture), then a timed one (seed 1). Returns
    (the server, the timed ``TranscribeRun``). Refuses the LM engine's
    flags (``refuse_lm_flags``)."""
    refuse_lm_flags(args, "serve_encdec")
    cfg = reduce_for_smoke(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"CUDA kernels built in {time.perf_counter() - t0:.1f}s")
    params = model_mod.init_params(cfg, seed=0, device=args.device)
    srv = EncDecServer(cfg, params, batch_size=args.slots)
    warm = srv.transcribe(*stub_batch(cfg, args.slots, seed=0),
                          args.new_tokens)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = srv.transcribe(*stub_batch(cfg, args.slots, seed=1),
                         args.new_tokens)
    if not ((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all():
        raise SystemExit("serve_encdec: a token outside the vocabulary")
    ex = srv.executor
    where = (f"{torch.cuda.get_device_name(0)}" if cuda else args.device)
    print(f"served {cfg.name} ({cfg.encdec.encoder_layers} + "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}) on {where}: "
          f"{args.slots} rows x {srv.enc_frames} frames; warm-up batch "
          f"{warm.wall_s:.3f} s; graphs captured {sum(ex.captures.values())}"
          f", replays {sum(ex.replays.values())}")
    print(run.report())
    if cuda:
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
    return srv, run


def _service_est(v: str):
    return v if v == "auto" else float(v)


def _chunk_arg(v: str):
    return v if v == "auto" else int(v)


# the LM engine's flags, which the encoder (``serve_encoder``) and the
# encoder-decoder (``serve_encdec``) paths do not take
LM_ONLY_FLAGS = ("--precision", "--verify-quant", "--replicas",
                 "--replica-precisions", "--prefill-chunk", "--prefix-cache",
                 "--policy")


def refuse_lm_flags(args, path: str) -> None:
    """Raise ``SystemExit`` naming every flag of ``LM_ONLY_FLAGS`` that
    ``args`` sets to other than its default: ``path`` would serve without
    it."""
    ap = _parser()
    dest = lambda flag: flag[2:].replace("-", "_")
    given = [f for f in LM_ONLY_FLAGS
             if getattr(args, dest(f)) != ap.get_default(dest(f))]
    if given:
        raise SystemExit(f"--arch {args.arch} serves through {path}, which "
                         f"does not take {', '.join(given)} (LM serving "
                         f"only)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b",
                    help="deepseek-7b, gemma2-27b, gemma-2b, "
                         "recurrentgemma-9b, qwen2-vl-7b (token prompts "
                         "at default M-RoPE positions) or mamba2-130m (SSD "
                         "blocks; w8a8 builds 0 sites), xlmr-paper for the "
                         "bucketed "
                         "encoder (--requests sentences, --slots a batch), "
                         "whisper-medium to transcribe (--slots rows, "
                         "--new-tokens a row), or dlrm for "
                         "the recommendation pipeline (--smoke reduces an LM "
                         "with reduce_for_smoke, which drops gemma-2b's and "
                         "qwen2-vl-7b's head padding and gemma-2b's "
                         "head_dim 256)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "edf", "sizetime", "priority"))
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency SLA for EDF + miss accounting")
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N engine replicas with the ReplicaRouter "
                         "(on the card they share the one device)")
    ap.add_argument("--route", default="count",
                    choices=("count", "feedback"),
                    help="router cost: ticket counts or EWMA of measured "
                         "per-replica step time")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded queue: shed submits past this depth")
    ap.add_argument("--service-ms-est", type=_service_est, default=None,
                    help="per-ticket service estimate for deadline-"
                         "feasibility shedding (a number, or 'auto' to "
                         "calibrate from live telemetry)")
    ap.add_argument("--steal", action="store_true",
                    help="cross-replica work stealing: idle replicas pull "
                         "pending fresh tickets from backlogged siblings")
    ap.add_argument("--verify-steal", action="store_true",
                    help="hot-spot all requests onto replica 0, drain it "
                         "mid-run, and check nonzero steals and zero lost "
                         "requests")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "w8a8"),
                    help="w8a8: serve the calibrated int8 weights")
    ap.add_argument("--replica-precisions", default=None,
                    help="comma list, one per replica (e.g. fp32,w8a8): a "
                         "mixed fleet where the router pins class-0 "
                         "traffic to fp32 replicas")
    ap.add_argument("--verify-quant", action="store_true",
                    help="single engine: replay on an unquantized engine "
                         "and check the greedy-token agreement guardrail; "
                         "mixed fleet: check class-0 routes to fp32 with "
                         "zero lost")
    ap.add_argument("--prefill-chunk", type=_chunk_arg, default=None,
                    help="split prompts into N-token chunks interleaved "
                         "with decode steps (LM only); 'auto' picks the "
                         "chunk at the performance model's efficiency "
                         "knee")
    ap.add_argument("--verify-chunked", action="store_true",
                    help="replay the trace monolithically and check that "
                         "chunked outputs are token-identical")
    ap.add_argument("--verify-autotune", action="store_true",
                    help="with --prefill-chunk auto: fit the performance "
                         "model from this run's replayed chunk calls, then "
                         "check the chosen chunk is on the ladder, at or "
                         "below the fitted knee, and token-identical to "
                         "chunk 16")
    ap.add_argument("--prefix-cache", type=int, default=None,
                    help="prefix cache capacity (entries): snapshot prompt "
                         "prefixes at chunk granularity and admit later "
                         "shared-prefix requests with their prefill "
                         "restored (needs --prefill-chunk)")
    ap.add_argument("--verify-prefix", action="store_true",
                    help="replay a hot-system-prompt trace through the "
                         "warm prefix cache and check nonzero hits with "
                         "outputs token-identical to a cold engine")
    ap.add_argument("--verify-fleet-prefix", action="store_true",
                    help="a fleet with the shared prefix tier under a "
                         "hot-system-prompt trace: check remote hits, zero "
                         "lost and outputs token-identical to cold prefill "
                         "(needs --replicas >= 2)")
    ap.add_argument("--elastic-smoke", action="store_true",
                    help="run the elastic fleet-controller scenario on the "
                         "deterministic fleet simulator (flash crowd and a "
                         "mid-crowd freeze) and check scale-up, scale-down "
                         "and the fault drain with zero lost; ignores the "
                         "engine flags")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.elastic_smoke:
        return elastic_smoke()
    if args.arch == "dlrm":
        return serve_dlrm(args)
    if get_config(args.arch).family == "encoder":
        return serve_encoder(args)
    if get_config(args.arch).encdec is not None:
        return serve_encdec(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
