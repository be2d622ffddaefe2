"""Serving entry point of the port: continuous Best-of-N over the paged KV
pool, on CUDA unless asked otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-1.5b \\
      --quantize --method best_of_n --budget 8 --tasks 4 \\
      --continuous --paged --kv-quant q8

Weights are random, from a seeded generator (the repository ships no
checkpoint).  ``--smoke`` selects the reduced config; ``--device cpu``
runs the kernels' plain versions on the CPU.  The paged-attention exp
mode comes from ``REPRO_TORCH_PAGED_ATTN`` (exact | lut).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import reward as R
from repro_torch.core.controller import TTSSpec, sweep
from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.quant.qlinear import cast_params, quantize_model_params
from repro_torch.serving.engine import DecodeEngine

MAX_LEN = 256


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--method", default="best_of_n", choices=["best_of_n"])
    ap.add_argument("--budget", type=int, default=8)
    ap.add_argument("--tasks", type=int, default=10)
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--quantize", action="store_true",
                    help="apply tile-group W4A16 quantization (paper §5.1)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the slot-based continuous-batching "
                         "scheduler (required: the port's only path)")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots for --continuous")
    ap.add_argument("--paged", action="store_true",
                    help="back the decode slots with the paged KV block "
                         "pool (required: the port's only KV layout)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size in tokens")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool size in blocks (0 = auto: one full-length "
                         "reservation per slot)")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "q8", "q4"],
                    help="store pool blocks tile-quantized (Q8 int8 / Q4 "
                         "packed codes + per-(2,16)-tile scales)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--dry", action="store_true",
                    help="smoke: shrink tasks/budget/tokens so the run "
                         "finishes in seconds")
    args = ap.parse_args(argv)
    if args.dry:
        args.tasks = min(args.tasks, 2)
        args.budget = min(args.budget, 4)
        args.max_tokens = min(args.max_tokens, 12)
    if not (args.continuous and args.paged):
        raise SystemExit("the port serves through --continuous --paged only")
    if MAX_LEN % args.block_size:
        raise SystemExit(f"--block-size must divide max_len={MAX_LEN}")
    return args


def build_engine(args) -> tuple:
    """(engine, tokenizer) for parsed ``args``: random params from seed 0
    on the requested device, optionally W4A16-quantized, cast once to the
    compute dtype."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tok = ByteTokenizer()
    if cfg.vocab_size < tok.vocab_size:
        cfg = cfg.with_(vocab_size=tok.vocab_size)
    params = api.get_model(cfg).init_params(cfg, seed=0, device=device)
    if args.quantize:
        params = quantize_model_params(params)
        print("[serve] weights quantized: tile-group Q4_0 + Q8_0 down-proj")
    params = cast_params(params, getattr(torch, cfg.dtype))
    rows = max(args.slots, args.budget)
    n_blocks = args.kv_blocks or 1 + rows * (MAX_LEN // args.block_size)
    engine = DecodeEngine(params, cfg, max_len=MAX_LEN, eos_id=tok.eos_id,
                          pad_id=tok.pad_id, block_size=args.block_size,
                          n_blocks=n_blocks, kv_quant=args.kv_quant)
    return engine, tok


def main(argv=None) -> list:
    """Run the serve and print its rows; returns the rows."""
    args = parse_args(argv)
    engine, tok = build_engine(args)
    print(f"[serve] device={engine.device} arch={engine.cfg.name} "
          f"kv_quant={args.kv_quant}")
    tasks = T.gen_dataset(123, args.tasks)
    spec = TTSSpec(method=args.method, budget=args.budget,
                   max_tokens=args.max_tokens)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(0)
    rows = sweep(engine, tok, tasks, [spec], gen, R.OracleVerifier(),
                 n_slots=args.slots)
    # leak check: after a full drain the pool holds no blocks
    in_use = engine.pool.blocks_in_use
    if in_use:
        raise SystemExit(f"[serve] KV pool leak: {in_use} blocks still in "
                         f"use after drain")
    print(f"[serve] kv pool clean: {in_use} blocks in use after drain")
    for r in rows:
        s = r["serving"]
        kv = s["kv"]
        print(f"[serve] {r['method']} budget={r['budget']} "
              f"accuracy={r['accuracy']:.3f} "
              f"decode_tokens={r['decode_tokens']}")
        print(f"[serve] continuous: slots={s['n_slots']} "
              f"occupancy={s['avg_slot_occupancy']:.2f} "
              f"requests_per_s={s['requests_per_s']:.2f} "
              f"decode_tok_per_s={s['decode_tok_per_s']:.1f} "
              f"prefill_tokens={s['prefill_tokens']} "
              f"prefill_calls={s['prefill_calls']} "
              f"preemptions={s['preemptions']}")
        print(f"[serve] latency: step_time_p50={s['step_time_p50'] * 1e3:.1f}"
              f"ms step_time_p99={s['step_time_p99'] * 1e3:.1f}ms")
        print(f"[serve] paged kv: block_size={kv['block_size']} "
              f"kv_quant={kv['kv_quant']} "
              f"peak_blocks={kv['peak_blocks_in_use']} "
              f"cow_copies={kv['cow_copies']} "
              f"peak_bytes={kv['peak_bytes_in_use']}")
    return rows


if __name__ == "__main__":
    main()
