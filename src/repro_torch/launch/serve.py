"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch
deepseek-7b --requests 16`` — continuous-batching LM serving with bucketed
batched prefill on the card (``--device cpu`` runs the plain versions of
the kernels on the host). ``--smoke`` (the default) serves the reduced
config; ``--full-config`` the published widths. The request trace is the
JAX launcher's: the same seeded generator, lengths and priorities.
``--arch dlrm`` serves the 4-stage DLRM pipeline on a row-wise int8 slab
(batches of 64 from ``dlrm_batches``, a full-trace warm-up first);
``--full-config`` is ``PAPER_COMPLEX`` with halved tables on one shard, the
size one 80 GB card holds.
``--precision w8a8`` serves the calibrated int8 path (the §V build step,
then the w8a8 kernel for every int8 site); ``--verify-quant`` replays the
trace on an unquantized engine and exits non-zero when the greedy-token
agreement falls below the 0.90 guardrail.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import dlrm_paper, get_config, reduce_for_smoke
from repro_torch.core.metrics import token_agreement
from repro_torch.data.synthetic import dlrm_batches
from repro_torch.kernels import _build
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import model as model_mod
from repro_torch.serving.dlrm_engine import DLRMEngine
from repro_torch.serving.engine import InferenceEngine, Request

# the JAX launcher's greedy-token-agreement guardrail for w8a8 serving
QUANT_AGREEMENT_THRESHOLD = 0.90


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


def serve_lm(args):
    cfg = reduce_for_smoke(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    if torch.device(args.device).type == "cuda":
        # set-up, not serving: without this the first prefill call would
        # compile the kernels inside the first requests' TTFT
        t0 = time.perf_counter()
        _build.build_all()
        print(f"CUDA kernels built in {time.perf_counter() - t0:.1f}s")
    if args.verify_quant and args.precision != "w8a8":
        raise SystemExit("--verify-quant needs --precision w8a8")
    params = model_mod.init_params(cfg, seed=0, device=args.device)
    kw = dict(batch_slots=args.slots, max_len=args.max_len,
              prefill_buckets=(16, 32, 64, 128), policy=args.policy,
              slo_ms=args.slo_ms, max_queue=args.max_queue,
              device=args.device)
    eng = InferenceEngine(cfg, params, precision=args.precision, **kw)
    reqs = _lm_requests(args, cfg)
    t0 = time.perf_counter()
    eng.run(reqs)
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    print(f"served {tel.served} requests in {wall:.2f}s on {args.device} "
          f"({tel.total_tokens / wall:.0f} tok/s, {tel.steps} decode steps, "
          f"{tel.prefills} prefills in {tel.prefill_batches} batched "
          f"dispatches)")
    print(tel.report())
    if args.verify_quant:
        ref = InferenceEngine(cfg, params, precision="fp32", **kw)
        ref_reqs = _lm_requests(args, cfg)
        ref.run(ref_reqs)
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
    eng = DLRMEngine(cfg, asn, params, policy=args.policy,
                     slo_ms=args.slo_ms, max_queue=args.max_queue,
                     device=args.device)
    batches = [next(dlrm_batches(cfg, 64, seed=s))
               for s in range(args.requests)]
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b",
                    help="deepseek-7b, or dlrm for the recommendation "
                         "pipeline")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "edf", "sizetime", "priority"))
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency SLA for EDF + miss accounting")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded queue: shed submits past this depth")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "w8a8"),
                    help="w8a8: serve the calibrated int8 weights")
    ap.add_argument("--verify-quant", action="store_true",
                    help="replay on an unquantized engine and check the "
                         "greedy-token agreement guardrail")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.arch == "dlrm":
        return serve_dlrm(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
