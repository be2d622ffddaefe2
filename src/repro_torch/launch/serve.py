"""Serving entry point of the port: test-time scaling (Best-of-N,
self-consistency, PRM beam search) over the paged KV pool (``--paged``)
or dense cache rows, on CUDA unless asked otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-1.5b \\
      --quantize --method best_of_n --budget 8 --tasks 4 \\
      --continuous --paged --kv-quant q8 [--prefix-cache --fewshot 3]
  ... --method self_consistency --budget 8 --paged       (direct path)
  ... --method beam_search --beam-width 2 --beam-expand 4 --beam-steps 4 \\
      --step-tokens 8 --paged [--continuous]
  ... --continuous --paged --spec-k 4 [--self-draft | --draft-model ARCH]
  ... --continuous --paged --kv-quant q8 --trace trace.json \\
      --profile profile.json [--canary-rate 0.25] [--metrics]
  ... --arch zamba2-1.2b --quantize --continuous        (dense rows)

``--continuous`` serves Best-of-N and beam search through the slot
scheduler; without it (and always for self-consistency) each task runs
the direct path: one prefill, fork, generate.  ``--spec-k`` turns each
scheduler step into a draft-then-verify round (greedy sampling forced),
drafted by the target itself or by a small registry model.  ``--trace``
writes the scheduler's Chrome trace (validate it with ``python -m
repro_torch.serving.telemetry``), ``--profile`` the kernel profile with
its numerics canary (``python -m repro_torch.serving.profiling``), and
``--metrics`` prints every summary key.  Without ``--paged`` each row owns
dense cache rows (the JAX package's default layout), the only layout of
the Mamba2 / zamba2 families, whose state is per row: the pool's options
(``--kv-quant``, ``--prefix-cache``, ``--spec-k``) then refuse, and the
profiler's canary never fires.  ``--arch`` takes every config of
``configs/registry.py``: the transformer family, dense and MoE
(olmoe-1b-7b, mixtral-8x7b), mamba2-130m and the zamba2-1.2b hybrid
(mamba2-130m has no W4A16 form: its ``in_proj`` does not tile, so
``--quantize`` raises, as in the JAX package).  Weights are random, from
a seeded generator unless ``--ckpt DIR`` restores a params-only
checkpoint (``checkpoint/checkpointer.py``; ``launch/train.py`` saves
{"params", "opt", "step"} trees, which, as in the JAX package, this
restore does not take).  ``--cache-capacity N`` bounds the prefix
cache's pinned blocks.  whisper-base is refused: neither the scheduler's
requests nor this entry point take the encoder's frames (nor do the JAX
package's); it serves through ``DecodeEngine``.  ``--smoke``
selects the reduced config; ``--device cpu`` runs the kernels' plain
versions on the CPU.  The paged-attention exp mode comes from
``REPRO_TORCH_PAGED_ATTN`` (exact | lut).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import reward as R
from repro_torch.core.controller import TTSSpec, sweep
from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.quant.qlinear import cast_params, quantize_model_params
from repro_torch.serving.engine import DecodeEngine, SpecConfig
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.profiling import KernelProfiler
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.telemetry import Tracer

MAX_LEN = 256


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--method", default="best_of_n",
                    choices=["best_of_n", "self_consistency", "beam_search"])
    ap.add_argument("--budget", type=int, default=8)
    ap.add_argument("--tasks", type=int, default=10)
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--quantize", action="store_true",
                    help="apply tile-group W4A16 quantization (paper §5.1)")
    ap.add_argument("--ckpt", default="",
                    help="restore trained params from this checkpoint "
                         "directory (a params-only tree, the JAX package's "
                         "format)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve best_of_n and beam_search through the "
                         "slot-based continuous-batching scheduler (else "
                         "the direct per-task path)")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots for --continuous")
    ap.add_argument("--paged", action="store_true",
                    help="back the decode rows with the paged KV block "
                         "pool (transformer family; else dense rows)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size in tokens")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool size in blocks (0 = auto: one full-length "
                         "reservation per row of the widest of the slots, "
                         "the budget and the beam fan-out)")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "q8", "q4"],
                    help="store pool blocks tile-quantized (Q8 int8 / Q4 "
                         "packed codes + per-(2,16)-tile scales)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="keep completed prompt prefixes pinned in the "
                         "paged KV pool (radix tree, LRU-evicted under "
                         "pressure) so requests sharing a system prompt / "
                         "few-shot header skip re-prefilling it; requires "
                         "--paged --continuous")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="max pool blocks the prefix cache may pin "
                         "(0 = bounded only by pool pressure)")
    ap.add_argument("--fewshot", type=int, default=0,
                    help="prepend a shared header of N worked examples to "
                         "every task prompt (the cross-request common "
                         "prefix the cache exploits)")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="surviving beams for --method beam_search "
                         "(0 = budget // 2)")
    ap.add_argument("--beam-expand", type=int, default=2,
                    help="candidates per surviving beam per step")
    ap.add_argument("--beam-steps", type=int, default=8,
                    help="reasoning-step scoring boundaries before final "
                         "selection")
    ap.add_argument("--step-tokens", type=int, default=16,
                    help="token budget per reasoning step")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft-then-verify rounds "
                         "committing up to K tokens per slot per step "
                         "(greedy acceptance: outputs stay those of plain "
                         "greedy decoding); 0 disables; requires "
                         "--continuous --paged; self-drafts unless "
                         "--draft-model is given")
    ap.add_argument("--draft-model", default="",
                    help="configs-registry arch of the small dense draft "
                         "model proposing tokens for --spec-k (smoke "
                         "config, vocab aligned to the target)")
    ap.add_argument("--self-draft", action="store_true",
                    help="draft with the target itself on a forked "
                         "(copy-on-write) snapshot of its paged state")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace-event JSON of the request "
                         "lifecycle (slots as tracks, scheduler/engine "
                         "phase spans as nested slices, pool gauges as "
                         "counters) to this path; open it at "
                         "https://ui.perfetto.dev; requires --continuous")
    ap.add_argument("--profile", default="",
                    help="write a roofline-attributed kernel-profile JSON "
                         "report (per-kernel analytic FLOPs/HBM bytes vs "
                         "sampled measured wall time, prefill/decode cost "
                         "breakdown, canary drift gauges) to this path; "
                         "validate with `python -m "
                         "repro_torch.serving.profiling PATH`; requires "
                         "--continuous")
    ap.add_argument("--canary-rate", type=float, default=0.25,
                    help="fraction of decode steps the profiler re-runs "
                         "through the exact path (plain paged attention, "
                         "the pool's plain dequant, f32 softmax) to "
                         "measure max logit error / argmax flip rate / KV "
                         "round-trip drift online (0 disables; only "
                         "active with --profile)")
    ap.add_argument("--metrics", action="store_true",
                    help="print every serving row's full "
                         "SchedulerMetrics.summary() dict (all latency "
                         "percentiles included) beside the one-line "
                         "summaries; requires --continuous")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--dry", action="store_true",
                    help="smoke: shrink tasks/budget/tokens so the run "
                         "finishes in seconds")
    args = ap.parse_args(argv)
    if get_config(args.arch).family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: an encoder-decoder decodes over its "
            f"audio frames, and neither the scheduler's requests nor this "
            f"entry point take frames (as in the JAX package); serve it "
            f"through DecodeEngine.prefill(tokens, lengths, "
            f"embeddings=frames), fork and generate")
    if args.dry:
        args.tasks = min(args.tasks, 2)
        args.budget = min(args.budget, 4)
        args.max_tokens = min(args.max_tokens, 12)
        args.beam_steps = min(args.beam_steps, 2)
        args.step_tokens = min(args.step_tokens, 8)
    if args.kv_quant != "none" and not args.paged:
        raise SystemExit("--kv-quant requires --paged (the quantized pool "
                         "is a block-pool storage layout)")
    if args.prefix_cache and not (args.paged and args.continuous):
        raise SystemExit("--prefix-cache requires --paged --continuous (the "
                         "cache lives in the paged block pool and is driven "
                         "by the scheduler)")
    if MAX_LEN % args.block_size:
        raise SystemExit(f"--block-size must divide max_len={MAX_LEN}")
    if (args.draft_model or args.self_draft) and not args.spec_k:
        raise SystemExit("--draft-model/--self-draft need --spec-k K "
                         "(the proposal budget per round)")
    if (args.trace or args.metrics) and not args.continuous:
        raise SystemExit("--trace/--metrics require --continuous (the "
                         "tracer records the scheduler's request "
                         "lifecycle)")
    if args.profile and not args.continuous:
        raise SystemExit("--profile requires --continuous (the profiler "
                         "samples the scheduler's decode steps)")
    if args.spec_k and not (args.paged and args.continuous):
        raise SystemExit("--spec-k requires --paged --continuous "
                         "(draft lanes and rejected suffixes are refcount "
                         "operations on the block pool)")
    return args


def spec_decode_of(args) -> Optional[SpecConfig]:
    """The speculative mode ``args`` ask for (None without --spec-k)."""
    if not args.spec_k:
        return None
    return SpecConfig(k=args.spec_k, draft_model=args.draft_model,
                      self_draft=args.self_draft or not args.draft_model)


def spec_of(args) -> TTSSpec:
    return TTSSpec(method=args.method, budget=args.budget,
                   max_tokens=args.max_tokens, beam_width=args.beam_width,
                   beam_expand=args.beam_expand, beam_steps=args.beam_steps,
                   step_tokens=args.step_tokens)


def build_engine(args) -> tuple:
    """(engine, tokenizer) for parsed ``args``: random params from seed 0
    (or ``--ckpt``'s) on the requested device, optionally W4A16-quantized,
    cast once to the compute dtype.  With ``--paged`` the pool holds one
    full-length sequence per row of the widest of the slots, the budget
    and the beam fan-out (the direct path forks that many rows at once and
    has no preemption to fall back on); without it each row owns dense
    cache rows."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tok = ByteTokenizer()
    if cfg.vocab_size < tok.vocab_size:
        cfg = cfg.with_(vocab_size=tok.vocab_size)
    if args.ckpt:
        from repro_torch.checkpoint.checkpointer import Checkpointer

        # a params-only checkpoint, as the JAX entry point restores
        params, _ = Checkpointer(args.ckpt).restore(
            api.abstract_params(cfg), device=device)
    else:
        params = api.get_model(cfg).init_params(cfg, seed=0, device=device)
    if args.quantize:
        params = quantize_model_params(params)
        print("[serve] weights quantized: tile-group Q4_0 + Q8_0 down-proj")
    params = cast_params(params, getattr(torch, cfg.dtype))
    fan = 0
    if args.method == "beam_search":
        width, expand = spec_of(args).beam_shape()
        fan = width * expand
    kv_kwargs = {}
    if args.paged:
        rows = max(args.slots, args.budget, fan)
        kv_kwargs = dict(
            paged=True, block_size=args.block_size, kv_quant=args.kv_quant,
            n_blocks=args.kv_blocks or 1 + rows * (MAX_LEN
                                                   // args.block_size))
    engine = DecodeEngine(params, cfg, max_len=MAX_LEN, eos_id=tok.eos_id,
                          pad_id=tok.pad_id, **kv_kwargs)
    return engine, tok


def main(argv=None) -> list:
    """Run the serve and print its rows; returns the rows."""
    args = parse_args(argv)
    engine, tok = build_engine(args)
    print(f"[serve] device={engine.device} arch={engine.cfg.name} "
          f"kv={'paged' if args.paged else 'dense'} "
          f"kv_quant={args.kv_quant} method={args.method} "
          f"path={'continuous' if args.continuous else 'direct'}")
    if args.continuous and args.method == "self_consistency":
        print("[serve] WARNING: --continuous serves best_of_n and "
              "beam_search through the scheduler; self_consistency takes "
              "the direct path")
    prefix_cache = None
    if args.prefix_cache:
        prefix_cache = PrefixCache(
            engine.pool, capacity_blocks=args.cache_capacity or None)
    if args.fewshot:
        tasks = T.shared_prefix_dataset(123, args.tasks,
                                        n_shots=args.fewshot)
    else:
        tasks = T.gen_dataset(123, args.tasks)
    spec_decode = spec_decode_of(args)
    sc = None
    if spec_decode is not None:
        # acceptance compares greedy argmaxes, so speculative serving
        # decodes greedily
        sc = SamplerConfig(greedy=True)
        print(f"[serve] speculative decoding: k={args.spec_k} "
              f"{'draft=' + args.draft_model if args.draft_model else 'self-draft'}"
              f" (greedy sampling forced)")
    tracer = Tracer() if args.trace or args.metrics else None
    profiler = (KernelProfiler(canary_rate=args.canary_rate)
                if args.profile else None)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(0)
    try:
        rows = sweep(engine, tok, tasks, [spec_of(args)], gen,
                     R.OracleVerifier(), continuous=args.continuous,
                     n_slots=args.slots, prefix_cache=prefix_cache,
                     tracer=tracer, profiler=profiler,
                     spec_decode=spec_decode, sc=sc)
    finally:
        if profiler is not None:
            profiler.uninstall()
    for path in (args.trace, args.profile):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if args.trace:
        tracer.write_chrome_trace(args.trace)
        print(f"[serve] trace: {len(tracer.events)} events / "
              f"{len(tracer.spans)} spans -> {args.trace} "
              f"(load in https://ui.perfetto.dev)")
    if profiler is not None:
        profiler.write_report(args.profile)
        ps = profiler.summary_metrics()
        print(f"[serve] profile: {len(profiler.report()['kernels'])} "
              f"kernels, kernel_time_share={ps['kernel_time_share']:.3f} "
              f"eff_p50={ps['roofline_efficiency_p50']:.3g} "
              f"canary_samples={ps['canary_samples']} "
              f"flip_rate={ps['canary_argmax_flip_rate']:.3g} "
              f"max_logit_err={ps['canary_max_logit_err']:.3g} "
              f"-> {args.profile}")
        for w in profiler.warnings:
            print(f"[serve] profile WARNING: {w}")
    if args.paged:
        # leak check: after a full drain the pool holds only the prefix
        # cache's pins
        pinned = (prefix_cache.stats()["cached_blocks"]
                  if prefix_cache is not None else 0)
        in_use = engine.pool.blocks_in_use
        if in_use != pinned:
            raise SystemExit(f"[serve] KV pool leak: {in_use} blocks still "
                             f"in use after drain (expected {pinned} "
                             f"cache-pinned)")
        print(f"[serve] kv pool clean: {in_use} blocks in use after drain "
              f"({pinned} cache-pinned)")
    for r in rows:
        print(f"[serve] {r['method']} budget={r['budget']} "
              f"accuracy={r['accuracy']:.3f} "
              f"decode_tokens={r['decode_tokens']}")
        if "serving" not in r:
            continue
        s = r["serving"]
        if args.metrics:
            for k in sorted(s):
                print(f"[serve]   {k}={s[k]}")
        print(f"[serve] continuous: slots={s['n_slots']} "
              f"occupancy={s['avg_slot_occupancy']:.2f} "
              f"requests_per_s={s['requests_per_s']:.2f} "
              f"decode_tok_per_s={s['decode_tok_per_s']:.1f} "
              f"prefill_tokens={s['prefill_tokens']} "
              f"prefill_calls={s['prefill_calls']} "
              f"calls_per_request={s['prefill_calls_per_request']:.2f} "
              f"admission_batch_max={s['admission_batch_max']} "
              f"preemptions={s['preemptions']}")
        # ttft / itl / queue_wait come from the tracer's per-request
        # records (0 without --trace/--metrics); step_time needs no tracer
        print(f"[serve] latency: "
              f"ttft_p50={s['ttft_p50'] * 1e3:.1f}ms "
              f"ttft_p99={s['ttft_p99'] * 1e3:.1f}ms "
              f"itl_p50={s['itl_p50'] * 1e3:.1f}ms "
              f"itl_p99={s['itl_p99'] * 1e3:.1f}ms "
              f"queue_wait_p99={s['queue_wait_p99'] * 1e3:.1f}ms "
              f"step_time_p50={s['step_time_p50'] * 1e3:.1f}ms "
              f"step_time_p99={s['step_time_p99'] * 1e3:.1f}ms")
        if s["spec_rounds"]:
            print(f"[serve] speculative: rounds={s['spec_rounds']} "
                  f"draft_tokens={s['draft_tokens']} "
                  f"acceptance_rate={s['spec_acceptance_rate']:.2f} "
                  f"accepted_tokens_per_step="
                  f"{s['accepted_tokens_per_step']:.2f}")
        if s["beam_boundaries"]:
            print(f"[serve] beam: boundaries={s['beam_boundaries']} "
                  f"expansions={s['beam_expansions']} "
                  f"prunes={s['beam_prunes']} "
                  f"prm_batches={s['prm_batches']} "
                  f"prm_candidates_per_batch="
                  f"{s['prm_candidates_per_batch']:.1f}")
        if "prefix_cache" in s:
            pc = s["prefix_cache"]
            print(f"[serve] prefix cache: hit_rate={pc['hit_rate']:.2f} "
                  f"tokens_matched={pc['tokens_matched']} "
                  f"prefill_tokens_saved={s['prefill_tokens_saved']} "
                  f"cached_blocks={pc['cached_blocks']} "
                  f"evictions={pc['evictions']}")
        if "kv" not in s:
            continue
        kv = s["kv"]
        print(f"[serve] paged kv: block_size={kv['block_size']} "
              f"kv_quant={kv['kv_quant']} "
              f"peak_blocks={kv['peak_blocks_in_use']} "
              f"cow_copies={kv['cow_copies']} "
              f"peak_bytes={kv['peak_bytes_in_use']}")
    return rows


if __name__ == "__main__":
    main()
