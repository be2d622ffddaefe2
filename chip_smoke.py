#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``card``: the GPU (nvidia-smi name and power limit), torch and CUDA
   versions;
2. ``build``: nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. ``kernel``: every kernel of the main path, at the main path's shapes,
   held against its plain PyTorch version on the same CUDA tensors
   (paged attention: exact 2e-5, LUT 2e-3 in f32; GEMM: 1e-3 f32, 2e-2
   bf16; bf16 outputs also allow one bf16 rounding step of relative error,
   since both sides round their f32 result to bf16), and timed with CUDA
   events beside its roofline bound, its plain version and one PyTorch
   library call computing the same function (timed only);
4. ``reference``: a small quantized model run on the GPU and on the CPU
   (plain versions) from the same weights and tokens; prefill and
   teacher-forced decode logits must agree;
5. ``serve``: ``repro_torch.launch.serve`` at the full width of
   qwen2.5-1.5b (28 layers, random seeded weights, W4A16) serving Best-of-8
   over 4 tasks on the paged pool, once per path: Q8, Q4 and bf16 KV, each
   in exact and LUT softmax.  Every request must complete, the pool must
   drain, and each run must launch its kernels exactly as often as its
   steps require (counters reset just before each run, read just after);
6. ``profile``: where a decode step's time goes, under ``torch.profiler``.

Then a ``{"kernels": [...]}`` line (each row's ``launches`` from the serve
run of its own path), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no ok line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (dense): HBM bytes/s and FLOP/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
GEMM_SRC = "src/repro_torch/kernels/csrc/lut_dequant_gemm.cu"
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:160",
    "quant_paged_attention": "src/repro/kernels/paged_attention.py:269",
    "lut_dequant_gemm": "src/repro/kernels/lut_dequant_gemm.py:71",
}
GEMM_KN = ((1536, 1536), (1536, 256), (1536, 8960))  # qwen2.5-1.5b Q4 (K, N)
SERVE_ARGS = ["--arch", "qwen2.5-1.5b", "--quantize", "--method",
              "best_of_n", "--budget", "8", "--tasks", "4", "--continuous",
              "--paged"]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device milliseconds per call.  A sleep kernel holds the stream
    while the host queues every call, so the CUDA events time the calls
    back to back on the device, without the host's launch overhead."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup  # enqueue cost per call
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles/s at the H100's top clock: sleep past the enqueue time
    torch.cuda._sleep(int(2e9 * (2 * host_s * iters + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 50) -> float:
    """Host wall milliseconds per call, queued back to back and ended by a
    synchronize: what a launch-bound caller pays."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(name, out, want, atol, rtol=0.0) -> float:
    import torch

    err = (out.float() - want.float()).abs()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    lim = atol + rtol * want.float().abs()
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.3e} "
                             f"over tolerance (atol {atol}, rtol {rtol})")
    return float(err.max())


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def paged_case(kind: str, dtype, seed: int):
    """Main-path decode shapes: B=8 slots, Hkv=2, G=6, D=128, 16-token
    blocks, W=16 (max_len 256); ragged lengths including 0 and full."""
    import torch

    from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

    B, Hkv, G, D, bs, W = 8, 2, 6, 128, 16, 16
    nb = 1 + B * W
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, Hkv, G, D), generator=gen, device="cuda")
         * 0.5).to(dtype)
    pools = []
    for _ in range(2):
        fp = torch.randn((nb, bs, Hkv, D), generator=gen, device="cuda") * 0.5
        if kind == "fp":
            pools.append(fp.to(dtype))
        else:
            gr, gc = kv_tile_geometry(Hkv, D)
            pools.append(quantize_kv(fp, mode=kind, gr=gr, gc=gc))
    lens = torch.tensor([0, 1, 15, 16, 33, 100, 200, 256], dtype=torch.int32)
    table = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        table[b, :n] = perm[used:used + n]
        used += n
    return (q, pools[0], pools[1], table.cuda(), lens.cuda())


def paged_bytes_flops(q, k_pool, table, lens, window: int):
    B, Hkv, G, D = q.shape
    if isinstance(k_pool, dict):
        c, s = k_pool["codes"], k_pool["scales"]
        slab = (c.shape[-2] * c.shape[-1] * c.element_size()
                + s.shape[-2] * s.shape[-1] * s.element_size())
    else:
        slab = Hkv * D * k_pool.element_size()
    toks = [min(int(n), window) if window > 0 else int(n)
            for n in lens.tolist()]
    qo = 2 * q.numel() * q.element_size()  # q read + out written
    nbytes = qo + 2 * sum(toks) * slab + table.numel() * 4 + lens.numel() * 4
    flops = 4.0 * Hkv * G * D * sum(toks)  # QK^T and P.V
    return nbytes, flops


def sdpa_library(q, k_pool, v_pool, table, lens):
    """``F.scaled_dot_product_attention`` over the gathered, dequantized
    KV (the yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import gather_blocks

    B, Hkv, G, D = q.shape
    W = table.shape[1]
    k = gather_blocks(k_pool, table.long())
    v = gather_blocks(v_pool, table.long())
    S = W * k.shape[2]
    k = k.reshape(B, S, Hkv, D).permute(0, 2, 1, 3).to(q.dtype)
    v = v.reshape(B, S, Hkv, D).permute(0, 2, 1, 3).to(q.dtype)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qq = q.reshape(B, Hkv * G, 1, D)
    mask = (torch.arange(S, device=q.device)[None] < lens[:, None].long())
    mask = mask[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask))


def plain_fn(mode: str):
    """The plain paged attention of ``mode`` as f(q, k, v, table, lens,
    lut, window)."""
    from repro_torch.kernels import paged_attention as PA

    if mode == "lut":
        return lambda q, k, v, t, n, lut, w: PA.plain_lut_paged_attention(
            q, k, v, t, n, lut, window=w)
    return lambda q, k, v, t, n, lut, w: PA.plain_paged_attention(
        q, k, v, t, n, window=w)


def check_paged_kernels(results: list) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    for kind in ("fp", "q8", "q4"):
        name = "paged_attention" if kind == "fp" else "quant_paged_attention"
        wrapper = PA.paged_attention if kind == "fp" else \
            PA.quant_paged_attention
        for mode in ("exact", "lut"):
            atol = 2e-5 if mode == "exact" else 2e-3
            plain = plain_fn(mode)
            for dtype in (torch.float32, torch.bfloat16):
                rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
                q, kp, vp, table, lens = paged_case(kind, dtype, seed=7)
                lut = ops.exp_lut(q.device) if mode == "lut" else None
                extra = () if kind == "fp" else (ops.q4_codebook(q.device),)
                errs = []
                for window in (0, 48):
                    out = wrapper(q, kp, vp, table, lens, lut, *extra,
                                  window=window, exp_mode=mode)
                    want = plain(q, kp, vp, table, lens, lut, window)
                    torch.cuda.synchronize()
                    errs.append(check_close(
                        f"{name}/{kind}/{mode}/{dtype}/w{window}", out, want,
                        atol, rtol))
                    if float(out[0].abs().max()) != 0.0:
                        raise AssertionError(f"{name}: zero-length row "
                                             f"is not exactly 0")
                if dtype != torch.bfloat16:
                    continue  # the main path runs bf16: time that
                run = lambda: wrapper(q, kp, vp, table, lens, lut, *extra,
                                      exp_mode=mode)
                ms, wall = time_ms(run), call_ms(run)
                plain_ms = time_ms(lambda: plain(q, kp, vp, table, lens,
                                                 lut, 0), iters=10)
                nbytes, flops = paged_bytes_flops(q, kp, table, lens, 0)
                b_ms, b_by = bound(nbytes, flops, "bfloat16")
                row = {"name": f"{name}/{kind}/{mode}", "route": "cuda",
                       "source": PAGED_SRC, "replaces": REPLACES[name],
                       "max_abs_err": max(errs), "ms": ms, "call_ms": wall,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": sdpa_library(q, kp, vp, table, lens),
                       "counter": name,
                       "path": f"{'none' if kind == 'fp' else kind}/{mode}"}
                emit("kernel", **row, shape="B8 Hkv2 G6 D128 bs16 W16",
                     dtype="bfloat16")
                results.append(row)


def gemm_case(M: int, K: int, N: int, dtype, seed: int):
    import torch

    from repro_torch.quant import tile_quant as TQ

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    qw = TQ.quantize(w, scheme="tile")
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    return x, qw


def check_gemm_kernel(results: list, prefill_m: int) -> None:
    import torch

    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.quant import tile_quant as TQ

    shapes = [(m, k, n) for m in (8, prefill_m) for (k, n) in GEMM_KN]
    # a ragged M over many 16-row tiles, checked only
    for (M, K, N) in shapes + [(300, 1536, 1536)]:
        errs = {}
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            x, qw = gemm_case(M, K, N, dtype, seed=M + N)
            args = (x, qw["codes"], qw["scales"], qw["codebook"])
            out = G.lut_dequant_gemm(*args)
            want = G.plain_lut_dequant_gemm(*args)
            torch.cuda.synchronize()
            rtol = tol if dtype == torch.float32 else tol + 2.0 ** -7
            errs[dtype] = check_close(f"lut_dequant_gemm/{M}x{K}x{N}/{dtype}",
                                      out, want, tol, rtol)
        if (M, K, N) not in shapes:
            emit("kernel_check", name="lut_dequant_gemm", M=M, K=K, N=N,
                 max_abs_err=max(errs.values()))
            continue
        w_lib = TQ.dequantize(qw, dtype=torch.bfloat16)
        ms = time_ms(lambda: G.lut_dequant_gemm(*args))
        wall = call_ms(lambda: G.lut_dequant_gemm(*args))
        plain_ms = time_ms(lambda: G.plain_lut_dequant_gemm(*args), iters=10)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib))
        nbytes = (x.numel() * 2 + qw["codes"].numel()
                  + qw["scales"].numel() * 2 + 64 + M * N * 2)
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N, "bfloat16")
        row = {"name": f"lut_dequant_gemm/M{M}xK{K}xN{N}", "route": "cuda",
               "source": GEMM_SRC, "replaces": REPLACES["lut_dequant_gemm"],
               "max_abs_err": max(errs.values()), "ms": ms, "call_ms": wall,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, "counter": (M, K, N),
               "path": "q8/exact"}
        emit("kernel", **row, dtype="bfloat16")
        results.append(row)


# ---------------------------------------------------------------------------
# small-input reference: GPU kernels vs CPU plain versions
# ---------------------------------------------------------------------------


def reference_check() -> None:
    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TR
    from repro_torch.quant.qlinear import quantize_model_params
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.kv_quant import QuantKVPool

    # head_dim 32: the smallest whose q4 KV rows (16 bytes) the kernel takes
    cfg = ModelConfig(name="reference", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab_size=320,
                      dtype="float32", qkv_bias=True, tie_embeddings=True)
    params_cpu = quantize_model_params(TR.init_params(cfg, seed=3,
                                                      device="cpu"))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    params_gpu = to(params_cpu, "cuda")
    rng = np.random.default_rng(0)
    B, S, steps, bs, W = 3, 12, 10, 8, 8
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(3, 300, (B, S)).astype(np.int32))
    forced = torch.from_numpy(rng.integers(3, 300, (B, steps)).astype(
        np.int32))
    table = torch.zeros((B, W), dtype=torch.int32)
    table[:, :4] = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)

    def run(params, dev, kv_quant):
        pool = (KVPool(cfg, 1 + B * W, bs, device=dev) if kv_quant == "none"
                else QuantKVPool(cfg, 1 + B * W, bs, mode=kv_quant,
                                 device=dev))
        cache = {"k": pool.k, "v": pool.v, "table": table.to(dev)}
        out = [TR.prefill(params, toks.to(dev), cfg, lengths=lens.to(dev),
                          paged=cache)]
        clen = lens.to(dev)
        for t in range(steps):
            clen = clen + 1
            out.append(TR.decode_step(params, forced[:, t:t + 1].to(dev),
                                      cache, clen, cfg))
        return torch.stack(out).cpu()

    # f32 on both sides, summed in other orders (~1e-6 on these logits);
    # a quantized pool can turn that into one flipped KV code, one
    # quantization step of an element (q8: absmax/127, q4: absmax/8)
    tols = {("none", "exact"): 1e-4, ("none", "lut"): 2e-3,
            ("q8", "exact"): 5e-3, ("q8", "lut"): 5e-3,
            ("q4", "exact"): 5e-2, ("q4", "lut"): 5e-2}
    for kv_quant in ("none", "q8", "q4"):
        for impl in ("exact", "lut"):
            tol = tols[kv_quant, impl]
            prev = L.set_paged_attention_impl(impl)
            try:
                got = run(params_gpu, "cuda", kv_quant)
                want = run(params_cpu, "cpu", kv_quant)
            finally:
                L.set_paged_attention_impl(prev)
            err = check_close(f"reference/{kv_quant}/{impl}", got, want, tol)
            emit("reference", kv_quant=kv_quant, impl=impl,
                 shape=list(got.shape), max_abs_err=err, atol=tol)


# ---------------------------------------------------------------------------
# the main path: full-width serving
# ---------------------------------------------------------------------------


# every (KV pool, softmax) path of the serve slice, the north-star path
# (Q8 KV, exact softmax) first; "none" is the bf16 pool of K1
SERVE_PATHS = [(kv, impl) for kv in ("q8", "q4", "none")
               for impl in ("exact", "lut")]


def serve_runs(prefill_m: int, n_layers: int = 28) -> dict:
    """Drive the serve entry point once per path.  Launch counts are reset
    just before and read just after each run, and kept per run: returns
    {"q8/exact": {"counts": {wrapper: n}, "shapes": {(M, K, N): n}}, ...}.
    """
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as L

    runs = {}
    for kv_quant, impl in SERVE_PATHS:
        path = f"{kv_quant}/{impl}"
        prev = L.set_paged_attention_impl(impl)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rows = serve.main(SERVE_ARGS + ["--kv-quant", kv_quant])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            shapes = ops.gemm_launches_by_shape()
        finally:
            L.set_paged_attention_impl(prev)
        s = rows[0]["serving"]
        attn = "paged_attention" if kv_quant == "none" else \
            "quant_paged_attention"
        if s["completed_requests"] != 4 or s["completed_samples"] != 32:
            raise AssertionError(f"serve {path}: not every request "
                                 f"completed: {s}")
        if s["kv"]["blocks_in_use"] != 0:
            raise AssertionError(f"serve {path}: pool did not drain")
        # one attention launch per layer per decode step; two Q4
        # projections per layer at each (K, N) per decode step (M = the 8
        # slots) and per prefill (M = the padded prompt)
        want = {attn: n_layers * s["steps"]}
        for k, n in GEMM_KN:
            want[(8, k, n)] = 2 * n_layers * s["steps"]
            want[(prefill_m, k, n)] = 2 * n_layers * s["prefill_calls"]
        got = {**counts, **shapes}
        if any(got.get(key, 0) != n for key, n in want.items()) or \
                counts["lut_dequant_gemm"] != sum(shapes.values()):
            raise AssertionError(f"serve {path}: launches {got}, expected "
                                 f"{want}")
        runs[path] = {"counts": counts, "shapes": shapes}
        emit("serve", kv_quant=kv_quant, impl=impl,
             accuracy=rows[0]["accuracy"],
             decode_tokens=s["decode_tokens"], steps=s["steps"],
             prefill_calls=s["prefill_calls"],
             decode_tok_per_s=s["decode_tok_per_s"],
             step_time_p50_ms=s["step_time_p50"] * 1e3,
             step_time_p99_ms=s["step_time_p99"] * 1e3,
             serve_wall_s=s["wall_s"], main_wall_s=wall,
             peak_device_bytes=torch.cuda.max_memory_allocated(),
             launches=counts,
             gemm_launches={"x".join(map(str, k)): v
                            for k, v in sorted(shapes.items())},
             attn_launches_per_decode_step=counts[attn] / max(1, s["steps"]),
             preemptions=s["preemptions"])
    return runs


def profile_decode() -> None:
    """Where a decode step's time goes at full width: one Best-of-8 task
    (Q8 KV, exact softmax) served under ``torch.profiler``; device busy
    share = summed kernel time over the serve's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import reward as R
    from repro_torch.core.controller import TTSSpec, sweep
    from repro_torch.data import tasks as T
    from repro_torch.launch import serve

    args = serve.parse_args(SERVE_ARGS + ["--kv-quant", "q8", "--tasks", "1",
                                          "--max-tokens", "16"])
    engine, tok = serve.build_engine(args)
    tasks = T.gen_dataset(123, 1)
    spec = TTSSpec("best_of_n", args.budget, args.max_tokens)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sweep(engine, tok, tasks, [spec], gen, R.OracleVerifier())  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows = sweep(engine, tok, tasks, [spec], gen, R.OracleVerifier())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = rows[0]["serving"]["steps"]
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    cpu_ops = sum(e.count for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::"))
    emit("profile", kv_quant="q8", impl="exact", steps=steps,
         wall_ms_per_step=wall * 1e3 / steps,
         device_ms_per_step=device_ms / steps,
         device_busy_share=device_ms / (wall * 1e3),
         aten_ops_per_step=cpu_ops / steps,
         top_kernels=[{"name": e.key[:80], "count": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.data import tasks as T
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(build.SOURCES))

    tok = ByteTokenizer()
    prefill_m = max(len(tok.encode(t.prompt))
                    for t in T.gen_dataset(123, 4))
    results: list = []
    check_paged_kernels(results)
    check_gemm_kernel(results, prefill_m)
    reference_check()
    runs = serve_runs(prefill_m)
    profile_decode()

    # each row's launches come from the serve run of its own path; K3 runs
    # on every path: its rows carry the north-star path's count at the
    # row's (M, K, N), and every path's count beside it
    kernels = []
    for row in results:
        row = dict(row)
        key = row.pop("counter")
        if isinstance(key, tuple):
            row["launches"] = runs[row["path"]]["shapes"].get(key, 0)
            row["launches_by_path"] = {p: r["shapes"].get(key, 0)
                                       for p, r in runs.items()}
        else:
            row["launches"] = runs[row["path"]]["counts"][key]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: not launched on its path")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
