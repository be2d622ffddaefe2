#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``card``: the GPU (nvidia-smi name and power limit), torch and CUDA
   versions;
2. ``build``: nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. ``dryrun``: ``python -m repro_torch.launch.dryrun`` on mamba2-130m's
   ``decode_32k`` cell of the 2x16x16 mesh (rank 0's program on the
   ``meta`` device, the card hidden from the process): its record, 512
   devices and FLOPs > 0; then ``run_cell`` of whisper-base's
   ``decode_32k`` cell with no mesh and W4A16 weights (128 rows against
   32768 cached positions), the same cell's arguments built on the card
   and its step run once (``dryrun_check``): the bytes the arguments
   take equal the dry-run's argument bytes up to the allocator's 512 B a
   tensor, the peak over them lies within ``DRYRUN_TEMP_RTOL`` of its
   temp bytes plus ``DRYRUN_SLACK``, and the K3 launches and hooked K3
   FLOPs equal the dry-run's hooked calls and kernel FLOPs;
4. ``kernel``: every kernel of the main path held against its plain
   PyTorch version on the same CUDA tensors (paged attention: exact 2e-5,
   LUT 2e-3 in f32; GEMM: 1e-3 f32, 2e-2 bf16; bf16 outputs also allow one
   bf16 rounding step of relative error, since both sides round their f32
   result to bf16; KV dequant: exactly equal), and timed with CUDA events
   beside its roofline bound, its plain version and one PyTorch library
   call computing the same function (timed only; none for the KV dequant).
   Paged attention runs here at the decode shapes, at its own split count,
   also timed at 1 and 4 splits and with 17 times the rows at 1 and 2,
   and at olmoe-1b-7b's decode shape (Hkv 16, G 1) on the two paths that
   serve it (Q8 exact, Q4 LUT), and at stablelm-3b's (Hkv 32, G 1, head
   dim 80: 40-byte Q4 code rows, loaded in 4-byte chunks) on Q4 pools in
   both softmaxes, and at the ``long`` path's 32,768-token Q8 cache (one
   row, 2,049 blocks); the GEMM and the KV dequant run after
   phase 6, at the shapes its runs launched them with, the GEMM and its
   library call timed hot (one weight back to back) and cold (a rotation
   over weight copies past the 50 MB L2), with the GEMM's regime;
5. ``reference``: a small quantized model run on the GPU and on the CPU
   (plain versions) from the same weights and tokens; prefill,
   teacher-forced decode and partial-prefill (cached prefix) logits must
   agree; then a small MoE model (its routing ids equal on both devices
   at every call) and a ``patch_stub`` model (prefill with a patch
   prefix) the same way; and a small W4A16 zamba2-style hybrid on dense
   rows (prefill, teacher-forced decode, then its conv / ssm states and
   shared-block KV), f32 on both sides and the GPU's bf16 against the
   CPU's f32; a small W4A16 Whisper the same way (every self and cross
   K/V leaf too); and one training step of a small f32 transformer
   (loss, every grad leaf and the updated params, TF32 off);
6. ``serve``: ``repro_torch.launch.serve`` at the full width of
   qwen2.5-1.5b (28 layers, random seeded weights, W4A16), once per path:
   continuous Best-of-8 over 4 tasks on Q8, Q4 and bf16 KV, each in exact
   and LUT softmax; then with the prefix cache over a shared 3-shot
   header: Best-of-8 over 4 tasks on Q8 KV, and 8 plain requests (one
   batched admission) on Q4 KV; then, on Q8 KV with exact softmax,
   self-consistency (Best-of-8, 32 tokens, 2 tasks) through the direct
   path, and PRM beam search (width 2 x expand 4, 4 boundaries of 8
   tokens, 2 tasks) through the scheduler's beam request class and
   through the direct path; then speculative decoding on Q8 KV, exact
   softmax, greedy continuous Best-of-8 over 4 tasks x 48 tokens: plain
   (``spec/base``), k = 4 self-drafting (``spec/self``) and k = 4 with the
   registry's dense draft model (``spec/draft``), whose greedy tokens are
   held against spec/base's (``spec_parity``: a row may leave them only at
   a near-tie, the base run's logit gap there at most ``SPEC_GAP``); then
   olmoe-1b-7b at its published width (16 layers, 64 experts of width
   1024, top-8, W4A16 with Q4 expert gate/up and Q8 expert down),
   continuous Best-of-8 over 2 tasks on Q8 KV (``moe/q8``), on Q4 KV with
   the LUT softmax (``moe/q4lut``) and on Q8 KV with the prefix cache over
   a 3-shot header (``moe/prefix``); then stablelm-3b at its published
   width (32 layers, d_model 2560, 32 KV heads of 80), W4A16, on Q4 KV
   with exact softmax and the prefix cache over a 3-shot header,
   continuous Best-of-8 over 2 tasks (``q4/stablelm``: K2 and K4 at its
   40-byte rows); then, on dense cache rows (no
   ``--paged``), Best-of-8 over 2 tasks: zamba2-1.2b at its published
   width (38 Mamba2 layers, d_model 2048, d_state 64; the shared
   attention + SwiGLU block after every 6th layer), W4A16, through the
   scheduler (``ssm/zamba2``) and the direct path
   (``ssm/zamba2-direct``), mamba2-130m in bf16 (``ssm/mamba2``: no
   W4A16 form, so no kernel) and qwen2.5-1.5b W4A16 (``dense/bf16``: K3
   only).  Launch counts follow each served model (``gemm_layout``:
   per forward 168 K3 for qwen2.5-1.5b, 64 for olmoe-1b-7b, 112 for
   zamba2-1.2b; paged attention once per layer on the pool, never on
   dense rows).  Every request must complete, the pool (where there is
   one) must drain to the cache's pinned blocks, and each run must launch its
   kernels exactly as often as its decode steps, prefills and
   speculative verifies require (counters reset just before each run,
   read just after; a verify launches K3 at M = slots x W and K4 twice).  Both routes
   are measured alike: ``decode_tokens`` counts the rows each decode step
   advances (frozen beam lanes and idle slots not) and the tokens each
   speculative round commits, ``decode_tok_per_s`` divides it by the
   wall time from the engine's build to the serve's end, and a step's
   time (p50, p99) is ``DecodeEngine._step_core``, or a whole
   speculative round, ended by a synchronize.  The memory peak is reset once the engine is
   built: ``peak_device_bytes`` is the serving peak,
   ``load_peak_device_bytes`` the weights' init, beside the pool's own
   ``peak_kv_bytes`` (dense paths: ``dense_cache_bytes``, the rows'
   cache from its shapes).  Then ``encdec/whisper``: whisper-base at its
   published width (6 + 6 layers, d_model 512, 1500 frames, vocab
   51865), W4A16, bf16, through ``DecodeEngine`` as the JAX package
   serves it (2 clips of random frames prefilled with 4-token prompts on
   dense rows, forked x 4, 48 tokens): exactly 84 K3 launches per
   prefill (42 at M = 3000) and 42 per decode step, every row finished.
   Then ``long`` (``long_phase``): qwen2.5-1.5b W4A16 on a Q8 pool, one
   prompt of 32,704 random seed-0 tokens prefilled through the chunked
   attention (168 K3 at M = 32,704), 64 greedy steps to a 32,768-token
   cache (28 K2 and 168 K3 a step), and the last prompt position's
   logits held against a prefill of one token fewer plus one decode step
   over the Q8 pool and over a bf16 pool (``LONG_LOGIT_RTOL``; the
   argmax equal, or the top-2 gap at most ``SPEC_GAP``); prefill ms,
   decode tok/s, peak bytes and the attention's working set from its
   tile shapes.
   Then ``train``: ``repro_torch.launch.train`` at qwen2.5-1.5b's
   published width, 6 steps of batch 8 x 128 (finite losses and grad
   norms, every param leaf but the key biases changed; step ms, tokens/s,
   peak bytes), the trained params saved as a checkpoint and restored
   (bytes and seconds), ``serve --ckpt`` Best-of-8 from it (W4A16, Q8 KV,
   ``train/serve-ckpt``), a 4-layer run resumed after a relaunch at
   step 4 (all under a temp dir in ``build/``, removed), and a run at
   train_4k's sequence length (``train_4k``: 3 steps of 2 x 4096, step
   ms and peak bytes beside ``TRAIN_4K_PREDICTED``).  Then ``dist``,
   the distributed layer on ranks that share the card over ``gloo``
   (``torch.distributed.run``; every collective through the host): the
   same ``launch/train.py`` run (3 steps of 8 x 128, its depth cut to
   ``DIST_TRAIN_LAYERS``) with ``--mesh 2x2`` (tensor parallel, the
   residual sequence-sharded) against one rank, each step's loss within
   ``TRAIN_RTOL`` and each rank's peak bytes; then 2 ranks:
   qwen2.5-1.5b W4A16 at its published width and depth decoding tensor
   parallel on a 1 x 2 mesh, each rank's weight blocks on "model", over a
   dense bf16 cache split along the sequence over "model" (8 rows, 32
   steps, teacher-forced with a one-rank decode's tokens, held to it by
   the ``SPEC_GAP`` rule, exactly 168 K3 launches a step on each rank at
   the sharded shapes, each rank's recorded collectives equal to the
   dry-run's count of the same program on meta: ``dist/seqpar``), ``distributed_sample`` over the 151,936-wide
   vocab (greedy = argmax, ties included), olmoe-1b-7b (2 layers) under
   a 1 x 2 mesh with tp against no mesh, ``compressed_psum`` of 64 MB
   against ``psum``, and the 2 x 2 checkpoint restored onto 1 x 2 and
   onto one rank bit for bit;
7. ``observe``: the serve again through ``--trace`` and ``--profile``
   (the request tracer, the kernel profiler with its numerics canary at
   rate 0.25), Best-of-8 over 2 tasks: Q8/exact off, on, off, on, then on
   with the canary off; Q4/LUT and q8/prefix on; spec/self traced;
   olmoe-1b-7b on Q8/exact on; zamba2-1.2b on dense rows on.  Each
   trace and report must pass the port's validators, each op's hooked
   calls must equal its kernel's launches outside the canary (28 paged
   attention and 168 K3 per decode step on qwen2.5-1.5b), the canary
   must launch no paged attention and, on dense rows, never run, and
   spec/self must record one ``spec_verify`` span per round.  One ``observe`` line per run (span totals and p50 by name,
   admission steps, TTFT / inter-token / queue-wait percentiles,
   ``kernel_time_share``, ``roofline_efficiency_p50``, per-op calls, bound
   and attributed wall, the canary's drift) and an ``observe_cost`` line
   (decode tok/s and step p50 off and on, in turns);
8. ``flash``: ``ops.flash_attention`` (K5) in its three exp modes (lut,
   poly, exact) at qwen2.5-1.5b's attention geometry (12 query heads, 2 KV
   heads, head_dim 128, causal) for (B, S) = (1, 2048), (8, 256) and
   (1, 79), and at the JAX package's Fig. 14 and Table 5 shapes; every
   output within 2e-3 of the plain version on the same CUDA tensors and
   within 2e-2 of f32 attention, and the full-width cases timed beside
   their bound, the plain version and ``F.scaled_dot_product_attention``
   (timed only);
9. ``quantize``: ``ops.tile_quantize_op`` (K6) over the 168 Q4
   projections of full-width qwen2.5-1.5b (28 layers x q, k, v, o, gate,
   up; the f32 weights the serve quantizes, seed 0); codes and scales
   exactly equal to the plain version, >= 99.9% of 4-bit codes equal to
   the offline quantizer's, and each leaf through K3 at M = 8 against
   ``dequant_matmul_ref``; each projection shape timed beside an empty
   kernel on its grid and on one block (the launch floor);
10. ``autotune`` (``autotune_phase``): ``kernels.autotune`` tunes K3 at
   qwen2.5-1.5b's Q4 shapes at M 8, 32 and 32,704 and at olmoe-1b-7b's
   and zamba2-1.2b's at M 8, K5 at B1 S2048 and K6 at the three
   projection shapes into a cache of its own (one ``autotune`` line per
   shape: each candidate's device ms, the analytic choice, the winner,
   K3's ``torch.matmul``), holds every K3 candidate, both K6 loads and
   K5's winner against the plain version, checks that each wrapper
   launches the recorded winner after ``autotune.reset()`` and the
   analytic choice under ``REPRO_AUTOTUNE=0``, and serves spec/base's
   greedy Best-of-8 with the empty cache and with the tuned one
   (``autotune/untuned``, ``autotune/tuned``), then zamba2-1.2b's greedy
   Best-of-8 on dense rows untuned, tuned, tuned, untuned
   (``autotune/zamba2/...``); tokens held by the ``SPEC_GAP`` rule, every
   K3 launch's plan checked, an ``autotune_serve`` line each (metrics
   averaged over a side's runs);
11. ``profile``: where a decode step's time goes, under ``torch.profiler``,
   with K3's and K1/K2's device ms per decode step, for qwen2.5-1.5b, for
   olmoe-1b-7b (with its experts' dequant and products timed by CUDA
   events at the step's shapes and set against the step) and for
   zamba2-1.2b on dense rows.

Phases 8 and 9 reset the counters, drive their entry point once per case,
and read the counts before any comparison or timing launches.  Every
phase but the autotune phase's tuning runs against an empty autotune
cache (``pin_autotune_cache``: ``REPRO_AUTOTUNE_CACHE`` set to a fresh
file under ``build/``), so each wrapper launches its analytic choice
whatever cache the machine holds.  Then a
``{"kernels": [...]}`` line (each row's ``launches`` from the run of its
own path or phase), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no ok line.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
GEMM_SRC = "src/repro_torch/kernels/csrc/lut_dequant_gemm.cu"
DEQUANT_SRC = "src/repro_torch/kernels/csrc/lut_dequant_kv.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/lut_softmax_attention.cu"
QUANT_SRC = "src/repro_torch/kernels/csrc/tile_quantize.cu"
REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:160",
    "quant_paged_attention": "src/repro/kernels/paged_attention.py:269",
    "lut_dequant_gemm": "src/repro/kernels/lut_dequant_gemm.py:71",
    "lut_dequant_kv": "src/repro/kernels/lut_dequant_gemm.py:148",
    "lut_softmax_attention": "src/repro/kernels/lut_softmax_attention.py:131",
    "tile_quantize": "src/repro/kernels/tile_quantize.py:35",
}
SERVE_ARGS = ["--arch", "qwen2.5-1.5b", "--quantize", "--method",
              "best_of_n", "--budget", "8", "--tasks", "4", "--continuous",
              "--paged"]  # continuous Best-of-8 over 4 tasks
MOE_ARCH = "olmoe-1b-7b"


def gemm_layout(cfg) -> dict:
    """{(K, N): launches} of K3 in one forward of ``cfg`` under
    ``DEFAULT_POLICY``, once its weights are quantized: per transformer
    layer the Q4 attention projections and the Q4 FFN gate and up of a
    dense layer (an MoE layer's experts are dequantized whole, not K3;
    every FFN down is Q8, not K3); per Mamba2 layer the Q4 ``in_proj``
    and ``out_proj``, and per application of the zamba2 hybrid's shared
    block (after every ``hybrid_attn_every``-th layer) its attention
    projections, gate and up; per Whisper decoder layer (a decode step,
    or a prefill's decoder) self q, k, v, o, cross q and o and fc1
    (``encoder_gemm_layout`` has a prefill's encoder side)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    attn = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
            (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d)]
    if cfg.family == "encdec":
        # the decoder, per decode step and per prefill (M = its tokens):
        # self q, k, v, o, cross q and o, fc1; the encoder's side is
        # encoder_gemm_layout
        blocks = [([attn[0], attn[3], (d, cfg.d_ff)] + attn,
                   cfg.n_layers)]
    elif cfg.family == "transformer":
        blocks = [(attn + ([] if cfg.moe else [(d, cfg.d_ff)] * 2),
                   cfg.n_layers)]
    else:
        s = cfg.ssm
        di = s.d_inner(d)
        n_in = 2 * di + 2 * s.ngroups * s.d_state + s.n_heads(d)
        apps = (cfg.n_layers // cfg.hybrid_attn_every
                if cfg.family == "hybrid" and cfg.hybrid_attn_every else 0)
        blocks = [([(d, n_in), (di, d)], cfg.n_layers),
                  (attn + [(d, cfg.d_ff)] * 2, apps)]
    out: dict = {}
    for shapes, times in blocks:
        for kn in shapes:
            out[kn] = out.get(kn, 0) + times
    return {kn: n for kn, n in out.items() if n}


def encoder_gemm_layout(cfg) -> dict:
    """{(K, N): launches} of K3 per encoder-decoder prefill at M = clips x
    T_enc: per encoder layer q, k, v, o and fc1 (fc2 is Q8), and per
    decoder layer the cross K and V of the encoder output."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    kv = (d, cfg.n_kv_heads * hd)
    out: dict = {}
    for kn, times in (((d, cfg.n_heads * hd), cfg.n_encoder_layers),
                      ((cfg.n_heads * hd, d), cfg.n_encoder_layers),
                      (kv, 2 * cfg.n_encoder_layers + 2 * cfg.n_layers),
                      ((d, cfg.d_ff), cfg.n_encoder_layers)):
        out[kn] = out.get(kn, 0) + times
    return out


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device milliseconds per call (``kernels.autotune.device_ms``): a
    sleep kernel holds the stream while the host queues every call, so
    the CUDA events time the calls back to back on the device, without
    the host's launch overhead."""
    from repro_torch.kernels import autotune as A

    return A.device_ms(fn, iters, warmup)


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


L2_BYTES = 50e6  # the H100's L2 cache


def copies_past_l2(nbytes: float) -> int:
    """How many distinct copies of an operand of ``nbytes`` a rotation
    needs so that each call finds its copy out of L2 (twice the L2)."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def time_ms_cold(fns) -> float:
    """Device milliseconds per call of a rotation over ``fns``, each on
    its own copy of the operands, so no call finds its weight in L2 (the
    served decode step streams 462 MB of Q4 codes per step)."""
    i = [0]

    def run():
        fns[i[0] % len(fns)]()
        i[0] += 1

    return time_ms(run, iters=max(50, 2 * len(fns)))


def bound(nbytes: float, flops: float, dtype: str):
    """(ms, what bounds it) at the H100's published dense peaks, the
    constants ``kernels/autotune.roofline_bound_s`` (the profiler's
    bound) reads."""
    from repro_torch.kernels import autotune as A

    t_bytes = nbytes / A.HBM_BW
    t_ops = flops / A.PEAK_FLOPS_BY_DTYPE[dtype]
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


def paged_case(kind: str, dtype, seed: int, Hkv: int = 2, G: int = 6,
               D: int = 128):
    """Main-path decode shapes: B=8 slots, 16-token blocks, W=16 (max_len
    256), D=128 and qwen2.5-1.5b's Hkv=2, G=6 (olmoe-1b-7b: Hkv=16, G=1;
    stablelm-3b: Hkv=32, G=1, D=80); ragged lengths including 0 and
    full."""
    import torch

    from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

    B, bs, W = 8, 16, 16
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


# the bytes and operations of each kernel's bound come from the cost
# models the profiler's roofline bound reads (kernels/autotune.py), at
# this run's inputs


def paged_bytes_flops(q, k_pool, table, lens, window: int):
    """K1/K2 over the tokens this input's rows attend (``paged_attn_cost``
    with the live count): q read and out written, K and V slabs in pool
    storage, the table and lengths."""
    from repro_torch.kernels import autotune as A
    from repro_torch.kernels import ops

    B, Hkv, G, D = q.shape
    toks = [min(int(n), window) if window > 0 else int(n)
            for n in lens.tolist()]
    leaf = k_pool["codes"] if isinstance(k_pool, dict) else k_pool
    flops, nbytes = A.paged_attn_cost(
        B, Hkv * G, table.shape[1], leaf.shape[1], D,
        slab_bytes=ops.pool_slab_bytes(k_pool), q_bytes=q.element_size(),
        tokens=sum(toks))
    return nbytes, flops


def gemm_bytes_flops(x, qw):
    """K3 (``gemm_cost``): x read and out written in x's dtype, the packed
    codes, the f16 scales and the codebook."""
    from repro_torch.kernels import autotune as A

    codes, scales = qw["codes"], qw["scales"]
    flops, nbytes = A.gemm_cost(
        x.shape[0], codes.shape[0], codes.shape[1] * 2,
        x_bytes=x.element_size(),
        scale_bytes=scales.numel() * scales.element_size())
    return nbytes, flops


def dequant_kv_bytes_flops(q, mode: str, gr: int, gc: int):
    """K4 (``dequant_kv_cost``): codes, f16 scales and the codebook in,
    f32 out."""
    from repro_torch.kernels import autotune as A

    R, H = q["codes"].shape[:2]
    D = q["scales"].shape[-1] * gc
    flops, nbytes = A.dequant_kv_cost(R, H, D, mode, gr=gr, gc=gc)
    return nbytes, flops


def quantize_bytes_flops(K: int, N: int):
    """K6 (``quantize_cost``): the f32 weight in, packed codes and the
    (K / 2, N / 16) f16 tile scales out."""
    from repro_torch.kernels import autotune as A

    flops, nbytes = A.quantize_cost(K, N, scale_bytes=K * N // 16)
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


# the paged attention's geometries: qwen2.5-1.5b's every (pool, softmax)
# path, olmoe-1b-7b's two (Q8 exact, Q4 LUT) and stablelm-3b's Q4 (head
# dim 80: 40-byte code rows, 4-byte chunks) in both softmaxes, beside its
# Q8 (80-byte rows, 16-byte chunks; checked and timed, no serving path);
# (Hkv, G, D, {(kind, mode): serving path} or None for qwen's
# "<kv>/<mode>", name suffix, [(kind, mode), ...])
MOE_PATH = {("q8", "exact"): "moe/q8", ("q4", "lut"): "moe/q4lut"}
STABLELM_PATH = {("q4", "exact"): "q4/stablelm", ("q4", "lut"): "q4/stablelm"}
PAGED_GEOMS = (
    (2, 6, 128, None, "", [(k, m) for k in ("fp", "q8", "q4")
                           for m in ("exact", "lut")]),
    (16, 1, 128, MOE_PATH, "/olmoe", [("q8", "exact"), ("q4", "lut")]),
    (32, 1, 80, STABLELM_PATH, "/stablelm", [("q4", "exact"), ("q4", "lut"),
                                             ("q8", "exact")]),
)


def check_paged_kernels(results: list) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    for Hkv, G, D, paths, suffix, cases in PAGED_GEOMS:
        for kind, mode in cases:
            name = "paged_attention" if kind == "fp" else \
                "quant_paged_attention"
            wrapper = PA.paged_attention if kind == "fp" else \
                PA.quant_paged_attention
            atol = 2e-5 if mode == "exact" else 2e-3
            plain = plain_fn(mode)
            for dtype in (torch.float32, torch.bfloat16):
                rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
                q, kp, vp, table, lens = paged_case(kind, dtype, seed=7,
                                                    Hkv=Hkv, G=G, D=D)
                lut = ops.exp_lut(q.device) if mode == "lut" else None
                extra = () if kind == "fp" else (ops.q4_codebook(q.device),)
                errs = []
                for window in (0, 48):
                    out = wrapper(q, kp, vp, table, lens, lut, *extra,
                                  window=window, exp_mode=mode)
                    want = plain(q, kp, vp, table, lens, lut, window)
                    torch.cuda.synchronize()
                    errs.append(check_close(
                        f"{name}/{kind}/{mode}{suffix}/{dtype}/w{window}",
                        out, want, atol, rtol))
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
                path = paths.get((kind, mode)) if paths else \
                    f"{'none' if kind == 'fp' else kind}/{mode}"
                row = {"name": f"{name}/{kind}/{mode}{suffix}",
                       "route": "cuda", "source": PAGED_SRC,
                       "replaces": REPLACES[name],
                       "max_abs_err": max(errs), "ms": ms, "call_ms": wall,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by,
                       "library_ms": sdpa_library(q, kp, vp, table, lens),
                       "splits": PA.splits(*q.shape[:2], table.shape[1]),
                       "counter": name, "path": path}
                if not paths:
                    # the same function at other split counts, through
                    # the wrappers' private launch (timed only): 1 and 4
                    # splits at this shape, and 1 and 2 at 17 times its
                    # rows (B Hkv = 272, where the wrappers take 2 splits)
                    cb = extra[0] if extra else None

                    def at(s, args=(q, kp, vp, table, lens)):
                        return time_ms(lambda: PA._launch(
                            *args, lut, cb, window=0, softcap=0.0,
                            exp_mode=mode, n_splits=s))

                    big = (q.repeat(17, 1, 1, 1), kp, vp,
                           table.repeat(17, 1), lens.repeat(17))
                    row["ms_by_splits"] = {
                        "B8": {s: at(s) for s in (1, 4)},
                        "B136": {s: at(s, big) for s in (1, 2)}}
                emit("kernel" if path else "kernel_check", **row,
                     shape=f"B8 Hkv{Hkv} G{G} D{D} bs16 W16",
                     dtype="bfloat16")
                if path:
                    results.append(row)


def gemm_case(M: int, K: int, N: int, dtype, seed: int):
    import torch

    from repro_torch.quant import tile_quant as TQ

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    qw = TQ.quantize(w, scheme="tile")
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    return x, qw


def check_gemm_kernel(results: list, gemm_mkn: dict) -> None:
    """K3 at every (M, K, N) the serve runs launched it with
    (``gemm_mkn``: (M, K, N) -> the serve path whose launches its row
    carries) and a ragged M."""
    import torch

    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.quant import tile_quant as TQ

    shapes = sorted(gemm_mkn)
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
        # hot: one weight back to back (in L2); cold: a rotation over
        # distinct copies of the weight, past the L2, as the served step
        # reads it
        ms = time_ms(lambda: G.lut_dequant_gemm(*args))
        wall = call_ms(lambda: G.lut_dequant_gemm(*args))
        wbytes = qw["codes"].numel() + qw["scales"].numel() * 2
        rot = [(qw["codes"].clone(), qw["scales"].clone())
               for _ in range(copies_past_l2(wbytes))]
        ms_cold = time_ms_cold([
            (lambda c=c, sc=sc: G.lut_dequant_gemm(x, c, sc, qw["codebook"]))
            for c, sc in rot])
        del rot
        plain_ms = time_ms(lambda: G.plain_lut_dequant_gemm(*args), iters=10)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib))
        rot = [w_lib.clone() for _ in range(copies_past_l2(
            w_lib.numel() * 2))]
        lib_cold = time_ms_cold([(lambda w=w: torch.matmul(x, w))
                                 for w in rot])
        del rot
        nbytes, flops = gemm_bytes_flops(x, qw)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        pl = AT.gemm_plan(M, K, N, torch.bfloat16)  # what the wrapper ran
        row = {"name": f"lut_dequant_gemm/M{M}xK{K}xN{N}", "route": "cuda",
               "source": GEMM_SRC, "replaces": REPLACES["lut_dequant_gemm"],
               "max_abs_err": max(errs.values()), "ms": ms,
               "ms_cold": ms_cold, "call_ms": wall, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library_ms_cold": lib_cold, "regime": pl.regime,
               "plan": {"mt": pl.mt, "wk": pl.wk, "kz": pl.kz},
               "counter": (M, K, N),
               "path": gemm_mkn[M, K, N]}
        emit("kernel", **row, dtype="bfloat16")
        results.append(row)


# qwen2.5-1.5b partial prefill over a 4-block (64-token) cached header:
# R = 28 layers x 64 tokens x rows, one Best-of-N group (1 row) or one
# batched admission of 7 requests; a single slab and a ragged R
DEQUANT_R = (28 * 64, 28 * 7 * 64, 1, 37)


def check_dequant_kv_kernel(results: list, kv_r: dict) -> None:
    """K4 against its plain version, exactly, for q8 and q4 at DEQUANT_R
    (qwen2.5-1.5b's (Hkv, D) = (2, 128)) and at every (mode, R, Hkv, D)
    the serve runs launched it with (``kv_r``: (mode, R, Hkv, D) -> that
    path); timed at R >= 1000, and a row of the kernels line where a path
    launched it."""
    import torch

    from repro_torch.kernels import lut_dequant_kv as LK
    from repro_torch.kernels import ops
    from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

    cb = ops.q4_codebook("cuda")
    cases = {(m, r, 2, 128) for m in ("q8", "q4") for r in DEQUANT_R}
    for mode, R, Hkv, D in sorted(cases | set(kv_r)):
        gr, gc = kv_tile_geometry(Hkv, D)
        gen = torch.Generator(device="cuda").manual_seed(R)
        x = torch.randn((R, Hkv, D), generator=gen, device="cuda") * 3.0
        q = quantize_kv(x, mode=mode, gr=gr, gc=gc)
        args = (q["codes"], q["scales"], cb)
        kw = dict(mode=mode, gr=gr, gc=gc)
        out = LK.lut_dequant_kv(*args, **kw)
        want = LK.plain_lut_dequant_kv(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(
                f"lut_dequant_kv/{mode}/R{R}: not bit-identical to the "
                f"plain version (max abs err "
                f"{float((out - want).abs().max()):.3e})")
        if R < 1000 and (mode, R, Hkv, D) not in kv_r:
            emit("kernel_check", name="lut_dequant_kv", mode=mode, R=R,
                 Hkv=Hkv, D=D, max_abs_err=0.0)
            continue
        run = lambda: LK.lut_dequant_kv(*args, **kw)
        b_ms, b_by = bound(*dequant_kv_bytes_flops(q, mode, gr, gc),
                           "float32")
        tag = "" if (Hkv, D) == (2, 128) else f"/Hkv{Hkv}" + (
            "" if D == 128 else f"D{D}")
        row = {"name": f"lut_dequant_kv/{mode}/R{R}{tag}",
               "route": "cuda",
               "source": DEQUANT_SRC,
               "replaces": REPLACES["lut_dequant_kv"], "max_abs_err": 0.0,
               "ms": time_ms(run), "call_ms": call_ms(run),
               "plain_ms": time_ms(lambda: LK.plain_lut_dequant_kv(
                   *args, **kw), iters=10),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "counter": ("kv", mode, R),
               "path": kv_r.get((mode, R, Hkv, D))}
        extra = dict(shape=f"R{R} Hkv{Hkv} D{D}", dtype="float32")
        if row["path"] is None:  # checked and timed, not on a path
            emit("kernel_check", **row, **extra)
            continue
        emit("kernel", **row, **extra)
        results.append(row)


# ---------------------------------------------------------------------------
# K5 and K6 through their ops entry points
# ---------------------------------------------------------------------------


def _case(name, B, Sq, Skv, Hq, Hkv, D, causal, kv_is_k=False, timed=False):
    return dict(name=name, B=B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv, D=D,
                causal=causal, kv_is_k=kv_is_k, timed=timed)


# qwen2.5-1.5b's attention (12 query heads, 2 KV heads, head_dim 128,
# causal) at a long prefill, a batch of short ones and the serve runs'
# cold prefill length 79 (prime: one 79-row KV block); then the JAX
# package's Fig. 14 shapes (benchmarks/kernel_ablation.py: B 2, H 4, D 64,
# non-causal, k = v, 8 and 16 query rows) and its Table 5 shape
FLASH_CASES = (
    _case("qwen2.5-1.5b/B1xS2048", 1, 2048, 2048, 12, 2, 128, True,
          timed=True),
    _case("qwen2.5-1.5b/B8xS256", 8, 256, 256, 12, 2, 128, True, timed=True),
    _case("qwen2.5-1.5b/B1xS79", 1, 79, 79, 12, 2, 128, True, timed=True),
    _case("fig14/q1_kv1024", 2, 8, 1024, 4, 4, 64, False, kv_is_k=True),
    _case("fig14/q16_kv2048", 2, 16, 2048, 4, 4, 64, False, kv_is_k=True),
    _case("tbl5", 2, 256, 256, 4, 4, 64, True),
)
FLASH_MODES = ("lut", "poly", "exact")
# max |out - f32 attention| the JAX package recorded (BENCH_kernels.json)
JAX_VS_F32 = {("fig14/q1_kv1024", "lut"): 4.79e-05,
              ("fig14/q1_kv1024", "exact"): 3.37e-05,
              ("fig14/q16_kv2048", "lut"): 3.37e-05,
              ("fig14/q16_kv2048", "exact"): 3.37e-05,
              ("tbl5", "lut"): 5.21e-04}


def flash_inputs(c: dict, dev: str = "cuda"):
    """(B, S, H, D) fp16 q, k, v from a numpy seed, x 0.5 normal."""
    import numpy as np
    import torch

    rng = np.random.default_rng(c["Sq"] * 7 + c["Skv"])
    q = rng.standard_normal((c["B"], c["Sq"], c["Hq"], c["D"])) * 0.5
    k = rng.standard_normal((c["B"], c["Skv"], c["Hkv"], c["D"])) * 0.5
    v = k if c["kv_is_k"] else \
        rng.standard_normal((c["B"], c["Skv"], c["Hkv"], c["D"])) * 0.5
    return [torch.from_numpy(x.astype(np.float32)).to(dev, torch.float16)
            for x in (q, k, v)]


def heads_first(x):
    """(B, S, H, D) -> contiguous (B * H, S, D)."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def flash_key(c: dict, mode: str):
    return (mode, c["B"] * c["Hq"], c["Sq"], c["Skv"], c["D"],
            c["Hq"] // c["Hkv"], c["causal"])


def flash_bytes_flops(c: dict, mode: str):
    """``attn_cost`` with k and v read once at Hkv heads (not at every
    query head) and the LUT's 64 KiB in lut mode, and its flops scaled to
    the (query, key) pairs the mask leaves (kpos <= qpos when causal)."""
    from repro_torch.kernels.autotune import attn_cost

    B, Sq, Skv, D = c["B"], c["Sq"], c["Skv"], c["D"]
    flops, nbytes = attn_cost(B * c["Hq"], Sq, Skv, D)
    nbytes += (attn_cost(B * c["Hkv"], 0, Skv, D)[1]
               - attn_cost(B * c["Hq"], 0, Skv, D)[1])
    if mode == "lut":
        nbytes += 32768 * 2
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if c["causal"]
             else Sq * Skv)
    return nbytes, flops * pairs / (Sq * Skv)


def flash_phase(results: list, dev: str = "cuda") -> dict:
    """Drive ``ops.flash_attention`` once per (case, exp mode) with the
    counters reset just before and read just after; then hold each output
    against the plain version on the same tensors (2e-3) and f32 attention
    (2e-2), and time the full-width cases.  Returns the phase's run
    {"counts", "by_shape"}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import lut_softmax_attention as LA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.autotune import attn_blocks

    t0 = time.perf_counter()
    inputs = {c["name"]: flash_inputs(c, dev) for c in FLASH_CASES}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = {(c["name"], mode): ops.flash_attention(
        *inputs[c["name"]], causal=c["causal"], exp_mode=mode)
        for c in FLASH_CASES for mode in FLASH_MODES}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_shape = dict(LA.lut_softmax_attention.shapes)
    want = {flash_key(c, m): 1 for c in FLASH_CASES for m in FLASH_MODES}
    if counts["lut_softmax_attention"] != len(outs) or by_shape != want:
        raise AssertionError(f"flash: launches {counts} {by_shape}, "
                             f"expected one per case and mode")
    lut = ops.exp_lut(dev)
    for c in FLASH_CASES:
        q, k, v = (heads_first(x) for x in inputs[c["name"]])
        G = c["Hq"] // c["Hkv"]
        # the KV block ops.flash_attention launched
        bkv = attn_blocks(c["B"] * c["Hq"], c["Sq"], c["Skv"], c["D"])[1]
        o32 = ref.attention_f32_ref(q, k.repeat_interleave(G, 0),
                                    v.repeat_interleave(G, 0),
                                    causal=c["causal"])
        for mode in FLASH_MODES:
            got = heads_first(outs[c["name"], mode])
            plain = lambda: LA.plain_lut_softmax_attention(
                q, k, v, lut, causal=c["causal"], bkv=bkv, exp_mode=mode,
                kv_group=G)
            want_o = plain()
            torch.cuda.synchronize()
            err = check_close(f"flash/{c['name']}/{mode}", got, want_o, 2e-3)
            err32 = check_close(f"flash/{c['name']}/{mode} vs f32", got,
                                o32, 2e-2)
            shape = (f"B{c['B']} Sq{c['Sq']} Skv{c['Skv']} Hq{c['Hq']} "
                     f"Hkv{c['Hkv']} D{c['D']} "
                     f"{'causal' if c['causal'] else 'full'} bkv{bkv}")
            extra = dict(shape=shape, dtype="float16", max_err_vs_f32=err32,
                         jax_recorded_err_vs_f32=JAX_VS_F32.get(
                             (c["name"], mode)))
            if not c["timed"]:
                emit("kernel_check", name=f"lut_softmax_attention/{mode}/"
                     f"{c['name']}", max_abs_err=err, **extra)
                continue
            run = lambda: LA.lut_softmax_attention(
                q, k, v, lut, causal=c["causal"], bkv=bkv, exp_mode=mode,
                kv_group=G)
            nbytes, flops = flash_bytes_flops(c, mode)
            b_ms, b_by = bound(nbytes, flops, "float16")
            qs, ks, vs = (x.transpose(1, 2).contiguous()
                          for x in inputs[c["name"]])
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=c["causal"], enable_gqa=True))
            row = {"name": f"lut_softmax_attention/{mode}/{c['name']}",
                   "route": "cuda", "source": FLASH_SRC,
                   "replaces": REPLACES["lut_softmax_attention"],
                   "max_abs_err": err, "ms": time_ms(run),
                   "call_ms": call_ms(run),
                   "plain_ms": time_ms(plain, iters=10), "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms,
                   "counter": ("by_shape", flash_key(c, mode)),
                   "path": "flash"}
            emit("kernel", **row, **extra)
            results.append(row)
    emit("flash", launches=counts["lut_softmax_attention"],
         cases=len(FLASH_CASES), modes=list(FLASH_MODES),
         seconds=time.perf_counter() - t0)
    return {"counts": counts, "by_shape": by_shape}


Q4_PROJECTIONS = (("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("gate", "up")))


def quantize_phase(results: list, dev: str = "cuda",
                   n_layers: int = 28) -> dict:
    """Drive ``ops.tile_quantize_op`` over every Q4 projection of
    full-width qwen2.5-1.5b (the f32 weights ``serve`` quantizes, seed 0),
    with the counters reset just before and read just after; then hold
    each leaf against the plain version (exactly), the offline quantizer
    (>= 99.9% of 4-bit codes) and, through K3 at M = 8, against
    ``dequant_matmul_ref``; time one weight of each shape.  Returns the
    phase's run {"counts", "by_shape"}."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tile_quantize as TK
    from repro_torch.models import transformer as TR
    from repro_torch.quant import tile_quant as TQ

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b"), n_layers=n_layers)
    params = TR.init_params(cfg, seed=0, device=dev)
    weights = [layer[grp][name]["w"] for layer in params["layers"]
               for grp, names in Q4_PROJECTIONS for name in names]
    del params
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    leaves = [ops.tile_quantize_op(w) for w in weights]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_shape = dict(TK.tile_quantize.shapes)
    want = {}
    for w in weights:
        want[tuple(w.shape)] = want.get(tuple(w.shape), 0) + 1
    if counts["tile_quantize"] != len(weights) or by_shape != want:
        raise AssertionError(f"quantize: launches {counts} {by_shape}, "
                             f"expected {want}")
    gen = torch.Generator(device=dev).manual_seed(0)
    agree, k3_err = 1.0, 0.0
    for w, leaf in zip(weights, leaves):
        codes, scales = TK.plain_tile_quantize(w)
        if not (torch.equal(leaf["codes"], codes)
                and torch.equal(leaf["scales"], scales)):
            raise AssertionError(f"tile_quantize {tuple(w.shape)}: not "
                                 f"bit-identical to the plain version")
        off = TQ.quantize(w, scheme="tile")
        agree = min(agree, float((TQ.unpack_int4(off["codes"])
                                  == TQ.unpack_int4(leaf["codes"])).float()
                                 .mean()))
        x = torch.randn((8, w.shape[0]), generator=gen, device=dev).to(
            torch.bfloat16)
        k3_err = max(k3_err, check_close(
            f"tile_quantize {tuple(w.shape)} -> K3",
            ops.lut_dequant_matmul(x, leaf),
            ref.dequant_matmul_ref(x, leaf["codes"], leaf["scales"],
                                   leaf["codebook"]), 2e-2, 2e-2 + 2.0 ** -7))
    if agree < 0.999:
        raise AssertionError(f"tile_quantize: {agree:.5f} of 4-bit codes "
                             f"equal to the offline quantizer's (< 0.999)")
    # the launch floor: an empty kernel timed the same way, on one block
    # and on each shape's grid
    one_block = torch.zeros((2, 32), device=dev)  # a one-block grid
    floor_1block = time_ms(lambda: TK.empty_launch(one_block))
    floors = {}
    for K, N in sorted(by_shape):
        w = next(w for w in weights if tuple(w.shape) == (K, N))
        b_ms, b_by = bound(*quantize_bytes_flops(K, N), "float32")
        run = lambda: TK.tile_quantize(w)
        floors[f"{K}x{N}"] = time_ms(lambda: TK.empty_launch(w))
        row = {"name": f"tile_quantize/K{K}xN{N}", "route": "cuda",
               "source": QUANT_SRC, "replaces": REPLACES["tile_quantize"],
               "max_abs_err": 0.0, "ms": time_ms(run),
               "call_ms": call_ms(run),
               "launch_floor_ms": floors[f"{K}x{N}"],
               "wide_loads": AT.quantize_wide(K, N, w.dtype),
               "plain_ms": time_ms(lambda: TK.plain_tile_quantize(w),
                                   iters=10),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "counter": ("by_shape", (K, N)), "path": "quantize"}
        emit("kernel", **row, dtype=str(w.dtype).removeprefix("torch."))
        results.append(row)
    emit("quantize", launches=counts["tile_quantize"], by_shape={
        "x".join(map(str, k)): n for k, n in sorted(by_shape.items())},
        min_code_agreement_vs_offline=agree, k3_max_abs_err=k3_err,
        empty_kernel_ms_1block=floor_1block, empty_kernel_ms_by_shape=floors,
        seconds=time.perf_counter() - t0)
    return {"counts": counts, "by_shape": by_shape}


# K3 tuned at the served shapes, at full width: qwen2.5-1.5b's Q4
# projections at M 8 (decode: 8 slots), 32 (a speculative verify: 8 slots
# x W 4) and 32,704 (the long prefill), olmoe-1b-7b's and zamba2-1.2b's
# at M 8; K5 at the flash phase's first timed case (B1 S2048) in lut mode;
# K6 at the quantize phase's three projection shapes (f32)
AUTOTUNE_M = (8, 32, 32704)
AUTOTUNE_ARCHS = (MOE_ARCH, "zamba2-1.2b")
AUTOTUNE_LARGE_M = dict(iters=3, rounds=2)  # up to ~10 ms a call


def autotune_shapes() -> list:
    """The (M, K, N) of K3 the autotune phase tunes, in order."""
    from repro_torch.configs.registry import get_config

    out = [(m, k, n) for m in AUTOTUNE_M
           for k, n in sorted(gemm_layout(get_config("qwen2.5-1.5b")))]
    for arch in AUTOTUNE_ARCHS:
        out += [(8, k, n) for k, n in sorted(gemm_layout(get_config(arch)))
                if (8, k, n) not in out]
    return out


def _plan_name(pl) -> str:
    return {"small_m": f"mt{pl.mt}/wk{pl.wk}/kz{pl.kz}",
            "large_m": f"kz{pl.kz}"}.get(pl.regime, pl.regime)


class _LaunchSpy:
    """Records what each launch of K3, K5 and K6 was: K3's (M, K, N,
    dtype, Plan) at ``lut_dequant_gemm._launch``, K5's (BH, Sq, Skv, bkv) where
    ``ops.flash_attention`` calls its wrapper, K6's (K, N, wide) at
    ``tile_quantize._launch``.  The wrappers' own globals stay as they
    are, so their launch counters count as always."""

    def __init__(self):
        import types

        from repro_torch.kernels import lut_dequant_gemm as G
        from repro_torch.kernels import lut_softmax_attention as LA
        from repro_torch.kernels import ops
        from repro_torch.kernels import tile_quantize as TK

        g, la, tk = G._launch, LA.lut_softmax_attention, TK._launch
        self.calls = []

        def gemm(x, codes, scales, codebook, out, pl, **kw):
            self.calls.append((*x.shape, out.shape[1], x.dtype, pl))
            return g(x, codes, scales, codebook, out, pl, **kw)

        def attn(q, k, v, lut, *, bkv=128, **kw):
            self.calls.append((*q.shape[:2], k.shape[1], bkv))
            return la(q, k, v, lut, bkv=bkv, **kw)

        def quant(w, wide):
            self.calls.append((*w.shape, wide))
            return tk(w, wide)

        self.swaps = ((G, "_launch", gemm),
                      (ops, "_attn", types.SimpleNamespace(
                          lut_softmax_attention=attn)),
                      (TK, "_launch", quant))
        self.orig = [getattr(m, n) for m, n, _ in self.swaps]

    def __enter__(self):
        for m, n, fn in self.swaps:
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.swaps, self.orig):
            setattr(m, n, fn)


def autotune_phase(dev: str = "cuda") -> dict:
    """``kernels.autotune`` on the card.  Tunes K3, K5 and K6
    (``tune_gemm`` / ``tune_attn`` / ``tune_quantize``: every candidate
    timed with CUDA events, the fastest recorded) into a cache of this
    phase's own, and prints one ``autotune`` line per shape (each
    candidate's device ms, the analytic choice and its ms, the winner, and
    for K3 ``torch.matmul`` on the dequantized weight, timed as the
    candidates: each call on its own copy of the weight, out of L2).  Holds
    every K3 candidate and both K6 loads against the plain version, and
    K5's winner at its own KV block.  Then, after ``autotune.reset()``,
    each wrapper must launch the recorded winner, and under
    ``REPRO_AUTOTUNE=0`` the analytic choice again.  Last, the served A/B:
    spec/base's greedy Best-of-8 (qwen2.5-1.5b W4A16, Q8 KV, exact, 4
    tasks x 48 tokens) with the empty cache the other phases run against
    (``autotune/untuned``), then with the tuned one (``autotune/tuned``),
    and zamba2-1.2b's greedy Best-of-8 on dense rows untuned, tuned,
    tuned, untuned (``autotune/zamba2/...``: its M8 shapes were never
    swept, and its winners differ from the plan), each K3 launch's plan
    recorded and checked; each tuned side's tokens held to its untuned
    side's (first runs) by the ``SPEC_GAP`` rule, the metrics averaged
    over each side's runs.  Returns {"winners"}."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.kernels import lut_softmax_attention as LA
    from repro_torch.kernels import ops
    from repro_torch.kernels import tile_quantize as TK
    from repro_torch.quant import tile_quant as TQ

    t0 = time.perf_counter()
    card = nvidia_smi()
    bf16 = torch.bfloat16
    pinned = os.environ["REPRO_AUTOTUNE_CACHE"]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="autotune-", dir=ROOT / "build")
    tuned = os.path.join(tmp, "autotune.json")
    gemm_win, gemm_ana, gemm_args = {}, {}, {}

    def use(cache, on=True):
        os.environ["REPRO_AUTOTUNE_CACHE"] = cache
        if on:
            os.environ.pop("REPRO_AUTOTUNE", None)
        else:
            os.environ["REPRO_AUTOTUNE"] = "0"
        AT.reset()

    try:
        use(tuned)
        for M, K, N in autotune_shapes():
            ms = AT.tune_gemm(M, K, N, dtype=bf16, device=dev,
                              **(AUTOTUNE_LARGE_M if M > G.SMALL_M else {}))
            ana = G.plan(M, K, N, bf16)
            best = min(ms, key=ms.get)
            x, qw = gemm_case(M, K, N, bf16, seed=M + N)
            args = (x, qw["codes"], qw["scales"], qw["codebook"])
            want = G.plain_lut_dequant_gemm(*args)
            err = 0.0
            for pl in ms:
                out = torch.empty((M, N), dtype=bf16, device=dev)
                G._launch(*args, out, pl)
                torch.cuda.synchronize()
                err = max(err, check_close(
                    f"autotune/lut_dequant_gemm/{M}x{K}x{N}/"
                    f"{_plan_name(pl)}", out, want, 2e-2, 2e-2 + 2.0 ** -7))
            del want, out
            w = TQ.dequantize(qw, dtype=bf16)
            rot = [w] + [w.clone() for _ in range(
                copies_past_l2(w.numel() * 2) - 1)]
            matmul_ms = time_ms_cold([(lambda w=w: torch.matmul(x, w))
                                      for w in rot])
            del rot, w
            gemm_win[M, K, N], gemm_ana[M, K, N] = best, ana
            gemm_args[M, K, N] = args
            emit("autotune", kernel="lut_dequant_gemm", M=M, K=K, N=N,
                 dtype="bfloat16", regime=ana.regime,
                 ms={_plan_name(p): t for p, t in ms.items()},
                 analytic=_plan_name(ana), analytic_ms=ms[ana],
                 winner=_plan_name(best), winner_ms=ms[best],
                 winner_over_analytic=ms[best] / ms[ana],
                 matmul_ms=matmul_ms, winner_over_matmul=ms[best] / matmul_ms,
                 candidates=len(ms), max_abs_err=err, timing="cold",
                 nvidia_smi=card)

        c = FLASH_CASES[0]
        BH, G_kv = c["B"] * c["Hq"], c["Hq"] // c["Hkv"]
        ms = AT.tune_attn(BH, c["Sq"], c["Skv"], c["D"], kv_group=G_kv,
                          causal=c["causal"], device=dev)
        attn_ana = (AT.pick_block(c["Sq"], 128), AT.pick_block(c["Skv"], 128))
        attn_win = min(ms, key=ms.get)
        emit("autotune", kernel="lut_softmax_attention", case=c["name"],
             exp_mode="lut", ms={f"bkv{b[1]}": t for b, t in ms.items()},
             analytic=f"bkv{attn_ana[1]}", analytic_ms=ms[attn_ana],
             winner=f"bkv{attn_win[1]}", winner_ms=ms[attn_win],
             winner_over_analytic=ms[attn_win] / ms[attn_ana],
             candidates=len(ms), timing="hot", nvidia_smi=card)

        q_win, q_ana, q_w = {}, {}, {}
        for K, N in sorted(gemm_layout(get_config("qwen2.5-1.5b"))):
            ms = AT.tune_quantize(K, N, dtype=torch.float32, device=dev)
            gen = torch.Generator(device=dev).manual_seed(K + N)
            w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
            codes, scales = TK.plain_tile_quantize(w)
            for wide in ms:
                got = TK._launch(w, wide)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], codes)
                        and torch.equal(got[1], scales)):
                    raise AssertionError(f"autotune/tile_quantize {K}x{N} "
                                         f"wide={wide}: not bit-identical "
                                         f"to the plain version")
            q_win[K, N] = min(ms, key=ms.get)
            q_ana[K, N] = TK.wide_loads(w)
            q_w[K, N] = w
            emit("autotune", kernel="tile_quantize", K=K, N=N,
                 dtype="float32", ms={f"wide={b}": t for b, t in ms.items()},
                 analytic=f"wide={q_ana[K, N]}", analytic_ms=ms[q_ana[K, N]],
                 winner=f"wide={q_win[K, N]}", winner_ms=ms[q_win[K, N]],
                 winner_over_analytic=ms[q_win[K, N]] / ms[q_ana[K, N]],
                 candidates=len(ms), max_abs_err=0.0, timing="cold",
                 nvidia_smi=card)

        # the plumbing: after reset() each wrapper launches the recorded
        # winner; under REPRO_AUTOTUNE=0 the analytic choice again
        qkv = flash_inputs(c, dev)
        lut = ops.exp_lut(dev)
        q, k, v = (heads_first(t) for t in qkv)
        pickup = {}
        for label, cache, on in (("tuned", tuned, True),
                                 ("off", tuned, False)):
            use(cache, on)
            with _LaunchSpy() as spy:
                for args in gemm_args.values():
                    G.lut_dequant_gemm(*args)
                outs = {mode: ops.flash_attention(*qkv, causal=c["causal"],
                                                  exp_mode=mode)
                        for mode in FLASH_MODES}
                for w in q_w.values():
                    TK.tile_quantize(w)
            torch.cuda.synchronize()
            pick = gemm_win if on else gemm_ana
            want_calls = [(*mkn, bf16, pick[mkn]) for mkn in gemm_args]
            bkv = (attn_win if on else attn_ana)[1]
            want_calls += [(BH, c["Sq"], c["Skv"], bkv)] * len(FLASH_MODES)
            want_calls += [(*kn, (q_win if on else q_ana)[kn]) for kn in q_w]
            if spy.calls != want_calls:
                raise AssertionError(f"autotune {label}: launched "
                                     f"{spy.calls}, expected {want_calls}")
            # K5 at the KV block it launched, against the plain version
            for mode, o in outs.items():
                check_close(f"autotune/flash/{label}/{mode}", heads_first(o),
                            LA.plain_lut_softmax_attention(
                                q, k, v, lut, causal=c["causal"], bkv=bkv,
                                exp_mode=mode, kv_group=G_kv), 2e-3)
            pickup[label] = len(spy.calls)
        del gemm_args, q_w, qkv, q, k, v, outs

        # the served A/Bs, each K3 launch's plan recorded; the tokens of
        # each side's first run held by spec_parity, the metrics averaged
        serves = {}
        for base, (src, tuned_path, halves) in AUTOTUNE_AB.items():
            spec, plans = {}, {}
            got = {base: [], tuned_path: []}
            order = ((base, pinned), (tuned_path, tuned))
            for path, cache in (order + order[::-1])[:2 * halves]:
                use(cache)
                with _LaunchSpy() as spy:
                    runs, sp = serve_runs({path: SERVE_PATHS[src]})
                got[path].append(runs[path])
                spec.setdefault(path, sp[path])
                spec["eos_id"] = sp["eos_id"]
                n = plans.setdefault(path, {})
                for M, K, N, dtype, pl in spy.calls:
                    key = f"{M}x{K}x{N}/{_plan_name(pl)}"
                    n[key] = n.get(key, 0) + 1
                    want = (gemm_win if cache == tuned and dtype == bf16
                            else {}).get((M, K, N)) or G.plan(M, K, N, dtype)
                    if pl != want:
                        raise AssertionError(f"{path}: K3 at {(M, K, N)} "
                                             f"launched {pl}, expected "
                                             f"{want}")
            spec_parity(spec, spec.pop("eos_id"), base=base,
                        paths=(tuned_path,))
            u, t = ({k: sum(r["metrics"][k] for r in got[p]) / len(got[p])
                     for k in got[p][0]["metrics"]}
                    for p in (base, tuned_path))
            serves[base] = t["decode_tok_per_s"] / u["decode_tok_per_s"]
            emit("autotune_serve", paths=[base, tuned_path], serves_as=src,
                 runs_each=halves,
                 **{f"{k}_{p}": m[k] for p, m in (("untuned", u),
                                                   ("tuned", t)) for k in m},
                 decode_tok_per_s_by_run={p: [r["metrics"][
                     "decode_tok_per_s"] for r in got[p]] for p in got},
                 k3_launches={p: [r["counts"]["lut_dequant_gemm"]
                                  for r in got[p]] for p in got},
                 k3_plans=plans,
                 tok_per_s_tuned_over_untuned=serves[base],
                 nvidia_smi=card)
        emit("autotune_done", pickup_launches=pickup,
             tok_per_s_tuned_over_untuned=serves, nvidia_smi=card,
             seconds=time.perf_counter() - t0)
    finally:
        use(pinned)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"winners": {"gemm": gemm_win, "attn": attn_win, "quantize":
                        q_win}}


# ---------------------------------------------------------------------------
# small-input reference: GPU kernels vs CPU plain versions
# ---------------------------------------------------------------------------


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


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
    params_gpu = to_device(params_cpu, "cuda")
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

    # partial prefill over cached prefixes: one block-aligned (16) and one
    # mid-block (11) cached length in one ragged batch; the GPU gathers
    # the prefix through K4 (two launches: K and V)
    from repro_torch.kernels import lut_dequant_kv as LK
    from repro_torch.serving.engine import DecodeEngine

    prompts = torch.from_numpy(rng.integers(3, 300, (2, 20)).astype(
        np.int32))
    clens = [16, 11]

    def partial(params, kv_quant):
        eng = DecodeEngine(params, cfg, max_len=64, paged=True, block_size=bs,
                           n_blocks=1 + 4 * W, kv_quant=kv_quant)
        full = eng.prefill(prompts)
        ctab = np.zeros((2, eng.table_width), np.int32)
        suffix = torch.zeros((2, 20 - min(clens)), dtype=torch.int32)
        for i, c in enumerate(clens):
            n = -(-c // bs)
            ctab[i, :n] = full.table[i, :n]
            eng.pool.retain(full.table[i, :n])
            suffix[i, :20 - c] = prompts[i, c:]
        lens = torch.tensor([20 - c for c in clens], dtype=torch.int32)
        st = eng.prefill(suffix, lens, cached_table=ctab,
                         cached_lens=np.array(clens))
        return torch.stack([full.pending_logits, st.pending_logits]).cpu()

    for kv_quant in ("q8", "q4"):
        tol = tols[kv_quant, "exact"]
        before = LK.lut_dequant_kv.launches
        got = partial(params_gpu, kv_quant)
        if LK.lut_dequant_kv.launches - before != 2:
            raise AssertionError("partial prefill did not gather its prefix "
                                 "through lut_dequant_kv twice")
        want = partial(params_cpu, kv_quant)
        err = check_close(f"reference/partial/{kv_quant}", got, want, tol)
        emit("reference", kv_quant=kv_quant, impl="exact",
             path="partial_prefill", cached_lens=clens,
             shape=list(got.shape), max_abs_err=err, atol=tol)


def reference_family_check(dev: str = "cuda") -> None:
    """The transformer family's other members, small, W4A16, GPU against
    CPU from the same weights: an MoE model (8 experts, top-2, capacity
    drops at its prefill's 36 tokens) on Q8 and Q4 KV, prefill,
    teacher-forced decode and a ragged partial prefill over cached
    prefixes (K4), with every call's routing ids equal on both devices;
    and a ``patch_stub`` model (internvl2's frontend) whose prefill takes
    a (B, 5, d) patch prefix, then teacher-forced decode."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import moe as MO
    from repro_torch.models import transformer as TR
    from repro_torch.quant.qlinear import quantize_model_params
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.kv_quant import QuantKVPool

    moe_cfg = ModelConfig(name="reference-moe", n_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=320,
                          dtype="float32",
                          moe=MoEConfig(n_experts=8, top_k=2,
                                        expert_d_ff=64))
    vlm_cfg = ModelConfig(name="reference-vlm", n_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=320,
                          dtype="float32", qkv_bias=True,
                          frontend="patch_stub")
    rng = np.random.default_rng(1)
    B, S, steps, bs, W = 3, 12, 10, 8, 8
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(3, 300, (B, S)).astype(np.int32))
    forced = torch.from_numpy(rng.integers(3, 300, (B, steps)).astype(
        np.int32))
    emb = torch.from_numpy(rng.standard_normal((B, 5, 128)).astype(
        np.float32))
    table = torch.zeros((B, W), dtype=torch.int32)
    table[:, :4] = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)
    routes: list = []
    orig_route = MO.route

    def recording(logits, m):
        out = orig_route(logits, m)
        routes.append(out[1].cpu())
        return out

    def run(cfg, params, dev, kv_quant, embeddings=None):
        pool = QuantKVPool(cfg, 1 + B * W, bs, mode=kv_quant, device=dev)
        cache = {"k": pool.k, "v": pool.v, "table": table.to(dev)}
        out = [TR.prefill(params, toks.to(dev), cfg, lengths=lens.to(dev),
                          paged=cache, embeddings=None if embeddings is None
                          else embeddings.to(dev))]
        clen = lens.to(dev)
        for t in range(steps):
            clen = clen + 1
            out.append(TR.decode_step(params, forced[:, t:t + 1].to(dev),
                                      cache, clen, cfg))
        return torch.stack(out).cpu()

    prompts = torch.from_numpy(rng.integers(3, 300, (2, 20)).astype(
        np.int32))
    clens = [16, 11]

    def partial(cfg, params, kv_quant):
        eng = DecodeEngine(params, cfg, max_len=64, paged=True, block_size=bs,
                           n_blocks=1 + 4 * W, kv_quant=kv_quant)
        full = eng.prefill(prompts)
        ctab = np.zeros((2, eng.table_width), np.int32)
        suffix = torch.zeros((2, 20 - min(clens)), dtype=torch.int32)
        for i, c in enumerate(clens):
            n = -(-c // bs)
            ctab[i, :n] = full.table[i, :n]
            eng.pool.retain(full.table[i, :n])
            suffix[i, :20 - c] = prompts[i, c:]
        st = eng.prefill(suffix, torch.tensor([20 - c for c in clens],
                                              dtype=torch.int32),
                         cached_table=ctab, cached_lens=np.array(clens))
        return torch.stack([full.pending_logits, st.pending_logits]).cpu()

    # f32 on both sides (tols as reference_check's); the routing ids of
    # every MoE call must match exactly
    tols = {"q8": 5e-3, "q4": 5e-2}
    MO.route = recording
    try:
        for cfg, kind in ((moe_cfg, "moe"), (vlm_cfg, "patch_stub")):
            params_cpu = quantize_model_params(TR.init_params(
                cfg, seed=4, device="cpu"))
            params_gpu = to_device(params_cpu, dev)
            for kv_quant in ("q8", "q4"):
                e = emb if kind == "patch_stub" else None
                paths = [("prefill_decode",
                          lambda p, d: run(cfg, p, d, kv_quant, e))]
                if kind == "moe":
                    paths.append(("partial_prefill",
                                  lambda p, d: partial(cfg, p, kv_quant)))
                for name, fn in paths:
                    routes.clear()
                    got = fn(params_gpu, dev)
                    n_gpu = len(routes)
                    want = fn(params_cpu, "cpu")
                    gpu_ids, cpu_ids = routes[:n_gpu], routes[n_gpu:]
                    if kind == "moe" and (not gpu_ids or len(gpu_ids) !=
                                          len(cpu_ids) or any(
                            not torch.equal(a, b)
                            for a, b in zip(gpu_ids, cpu_ids))):
                        raise AssertionError(f"reference/{kind}/{kv_quant}/"
                                             f"{name}: routing ids differ "
                                             f"between GPU and CPU")
                    err = check_close(f"reference/{kind}/{kv_quant}/{name}",
                                      got, want, tols[kv_quant])
                    emit("reference", model=kind, kv_quant=kv_quant,
                         impl="exact", path=name, shape=list(got.shape),
                         max_abs_err=err, atol=tols[kv_quant],
                         route_calls=n_gpu)
    finally:
        MO.route = orig_route


def reference_ssm_check(dev: str = "cuda") -> None:
    """The Mamba2 / zamba2 family, small, W4A16, GPU against CPU from the
    same weights and tokens: a hybrid of 4 Mamba2 layers (d_model 64,
    d_state 24, 16 heads of 8) with the shared attention + SwiGLU block
    (4 heads of 16, d_ff 128) after layers 1 and 3, whose every
    projection tiles into Q4 groups (in_proj 64 -> 2 x 128 + 2 x 24 + 16
    = 320).  Ragged prompts (12, 5, 9 in a width of 12) prefilled into
    dense rows, then 10 teacher-forced decode steps: each call's logits,
    and after the last the conv and ssm states and the shared block's
    K/V, agree.  f32 on both sides (K3's CUDA-core plan); then the GPU in
    bf16 (K3's tensor-core plans, at M 36 and M 3) against the CPU's f32.
    K3 launches 20 times per call on the GPU (4 x (in_proj, out_proj) + 2
    x (q, k, v, o, gate, up))."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig, SSMConfig
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.models import mamba2 as MB
    from repro_torch.quant.qlinear import cast_params, quantize_model_params

    cfg = ModelConfig(name="reference-hybrid", family="hybrid", n_layers=4,
                      d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                      d_ff=128, vocab_size=320, hybrid_attn_every=2,
                      dtype="float32",
                      ssm=SSMConfig(d_state=24, head_dim=8, expand=2,
                                    conv_width=4, chunk_size=8))
    per_call = sum(gemm_layout(cfg).values())
    params_cpu = quantize_model_params(MB.init_params(cfg, seed=5,
                                                      device="cpu"))
    rng = np.random.default_rng(2)
    B, S, steps = 3, 12, 10
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(3, 300, (B, S)).astype(np.int32))
    forced = torch.from_numpy(rng.integers(3, 300, (B, steps)).astype(
        np.int32))

    def run(c, params, d):
        params = cast_params(params, getattr(torch, c.dtype))
        cache = MB.init_cache(c, B, 32, device=d)
        before = G.lut_dequant_gemm.launches
        out = [MB.prefill(params, toks.to(d), c, lengths=lens.to(d),
                          cache=cache)]
        clen = lens.to(d)
        for t in range(steps):
            clen = clen + 1
            out.append(MB.decode_step(params, forced[:, t:t + 1].to(d),
                                      cache, clen, c))
        launched = G.lut_dequant_gemm.launches - before
        if d != "cpu" and launched != per_call * (1 + steps):
            raise AssertionError(f"reference/ssm: {launched} K3 launches, "
                                 f"expected {per_call * (1 + steps)}")
        return torch.stack(out).cpu(), {k: v.float().cpu()
                                        for k, v in cache.items()}

    want, want_cache = run(cfg, params_cpu, "cpu")
    # f32 on both sides, summed in other orders: tolerances as
    # reference_check's fp case.  bf16 keeps 8 bits (2^-9 relative per
    # rounding), compounded over 4 blocks, 2 shared blocks and a 10-step
    # recurrence: 10% of each tensor's largest magnitude (bf16 against
    # f32 on the CPU with this model: 1.2-3.7%)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        got, got_cache = run(c, to_device(params_cpu, dev), dev)
        errs, ranges = {}, {}
        for name, g, w in [("logits", got, want)] + [
                (k, got_cache[k], want_cache[k]) for k in want_cache]:
            ranges[name] = float(w.abs().max())
            tol = 1e-4 if dtype == "float32" else 0.1 * ranges[name]
            errs[name] = check_close(f"reference/ssm/{dtype}/{name}", g, w,
                                     tol, 1e-4 if dtype == "float32" else 0)
        emit("reference", model="hybrid", dtype=dtype, kv="dense",
             path="prefill_decode", shape=list(got.shape),
             max_abs_err=errs, max_abs_reference=ranges,
             k3_launches_per_call=per_call,
             plans={f"M{m}": G.plan(m, 64, 320, getattr(torch, dtype)).regime
                    for m in (B, B * S)},
             atol=("1e-4 (rtol 1e-4)" if dtype == "float32"
                   else "0.1 x max |reference|"))


def reference_whisper_check(dev: str = "cuda") -> None:
    """The Whisper encoder-decoder, small, W4A16, GPU against CPU from the
    same weights, frames and tokens: 2 + 2 layers of d_model 64 (4 heads
    of 16, d_ff 128, every projection tiling into Q4 groups), 24 frames,
    ragged prompts (12, 5, 9 in a width of 12) prefilled into dense rows,
    then 10 teacher-forced decode steps: each call's logits and, after
    the last, every cache leaf (self and cross K/V).  f32 on both sides,
    then the GPU in bf16 against the CPU's f32, as the hybrid's check.
    K3 launches 28 times per prefill (2 x (q, k, v, o, fc1) in the
    encoder, 2 x (cross k, v), 2 x 7 in the decoder) and 14 per decode
    step on the GPU."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.models import whisper as W
    from repro_torch.quant.qlinear import cast_params, quantize_model_params

    cfg = ModelConfig(name="reference-whisper", family="encdec",
                      n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=320,
                      qkv_bias=True, rope_theta=0.0, encoder_seq_len=24,
                      max_seq_len=64, tie_embeddings=True, dtype="float32")
    per_prefill = sum(gemm_layout(cfg).values()) + sum(
        encoder_gemm_layout(cfg).values())
    per_step = sum(gemm_layout(cfg).values())
    params_cpu = quantize_model_params(W.init_params(cfg, seed=6,
                                                     device="cpu"))
    rng = np.random.default_rng(4)
    B, S, steps = 3, 12, 10
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(3, 300, (B, S)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    forced = torch.from_numpy(rng.integers(3, 300, (B, steps)).astype(
        np.int32))

    def run(c, params, d):
        params = cast_params(params, getattr(torch, c.dtype))
        cache = W.init_cache(c, B, 32, device=d)
        before = G.lut_dequant_gemm.launches
        out = [W.prefill(params, toks.to(d), c, lengths=lens.to(d),
                         cache=cache, embeddings=frames.to(d))]
        clen = lens.to(d)
        for t in range(steps):
            clen = clen + 1
            out.append(W.decode_step(params, forced[:, t:t + 1].to(d),
                                     cache, clen, c))
        launched = G.lut_dequant_gemm.launches - before
        if d != "cpu" and launched != per_prefill + per_step * steps:
            raise AssertionError(f"reference/whisper: {launched} K3 "
                                 f"launches, expected "
                                 f"{per_prefill + per_step * steps}")
        return torch.stack(out).cpu(), {k: v.float().cpu()
                                        for k, v in cache.items()}

    want, want_cache = run(cfg, params_cpu, "cpu")
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        got, got_cache = run(c, to_device(params_cpu, dev), dev)
        errs, ranges = {}, {}
        for name, g, w in [("logits", got, want)] + [
                (k, got_cache[k], want_cache[k]) for k in want_cache]:
            ranges[name] = float(w.abs().max())
            tol = 1e-4 if dtype == "float32" else 0.1 * ranges[name]
            errs[name] = check_close(f"reference/whisper/{dtype}/{name}", g,
                                     w, tol,
                                     1e-4 if dtype == "float32" else 0)
        emit("reference", model="whisper", dtype=dtype, kv="dense",
             path="prefill_decode", shape=list(got.shape),
             max_abs_err=errs, max_abs_reference=ranges,
             k3_launches_per_prefill=per_prefill,
             k3_launches_per_step=per_step,
             atol=("1e-4 (rtol 1e-4)" if dtype == "float32"
                   else "0.1 x max |reference|"))


def reference_train_check(dev: str = "cuda") -> None:
    """One training step of a small f32 transformer (2 layers, d_model
    128, GQA 4:2, QKV bias, remat full) on the GPU against the CPU from
    the same params and batch, TF32 off: the loss within 1e-5 relative
    and every grad leaf within 1e-4 of its largest magnitude (floored at
    1e-3 of the tree's largest: a key bias's grad is zero in exact
    arithmetic), then the AdamW update's params (eps 1e-5) within
    1e-5."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as TR
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = ModelConfig(name="reference-train", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=320,
                      qkv_bias=True, dtype="float32", param_dtype="float32")
    params_cpu = TR.init_params(cfg, seed=8, device="cpu")
    rng = np.random.default_rng(9)
    batch = (rng.integers(3, 300, (4, 32)).astype(np.int32),
             rng.integers(3, 300, (4, 32)).astype(np.int32),
             (rng.random((4, 32)) > 0.1).astype(np.float32))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for d in ("cpu", dev):
            # a copy on either device: the step updates its params in place
            params = T.map_with_path(lambda _, t: t.to(d, copy=True),
                                     params_cpu)
            tb = TL.to_batch(batch, d)
            (loss, _), grads = TL.value_and_grad(params, tb, cfg)
            # eps 1e-5: Adam would turn a grad element that is zero but
            # for rounding into a full step of either sign
            step = TL.make_train_step(cfg, AdamWConfig(
                lr=1e-3, warmup_steps=0, eps=1e-5))
            new, _, _ = step(params, init_opt_state(params), tb)
            out[d] = (float(loss), to_device(grads, "cpu"),
                      to_device(new, "cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (lw, gw, pw), (lg, gg, pg) = out["cpu"], out[dev]
    if not abs(lg - lw) <= 1e-5 * abs(lw):
        raise AssertionError(f"reference/train: loss {lg} vs {lw}")
    want = T.stacked_leaves(gw)
    top = max(float(torch.stack(w).abs().max()) for _, w, _ in want)
    errs = {}
    for (path, g, _), (_, w, _) in zip(T.stacked_leaves(gg), want):
        g, w = torch.stack(g), torch.stack(w)
        scale = max(float(w.abs().max()), 1e-3 * top)
        errs[path] = float((g - w).abs().max())
        if errs[path] > 1e-4 * scale:
            raise AssertionError(f"reference/train: grad {path} "
                                 f"{errs[path]:.3e} over 1e-4 x {scale:.3e}")
    perr = max(float((torch.stack(a) - torch.stack(b)).abs().max())
               for (_, a, _), (_, b, _) in zip(T.stacked_leaves(pg),
                                               T.stacked_leaves(pw)))
    if perr > 1e-5:
        raise AssertionError(f"reference/train: updated params {perr:.3e}")
    emit("reference", model="train", dtype="float32", loss=lg,
         loss_reference=lw, grad_leaves=len(errs),
         grad_max_abs_err=max(errs.values()), params_max_abs_err=perr,
         tolerance="loss 1e-5 rel, grads 1e-4 x leaf max, params 1e-5")


# ---------------------------------------------------------------------------
# the main path: full-width serving
# ---------------------------------------------------------------------------


# every (KV pool, softmax) path of the continuous Best-of-8 serve, the
# north-star path (Q8 KV, exact softmax) first; "none" is the bf16 pool of
# K1.  Then the prefix-cache paths (exact softmax) over a shared 3-shot
# header: the north-star path with the cache (Best-of-8 groups, one
# partial prefill per hit), and plain requests on Q4 KV (the batched
# ragged admission).  Then the paper's other two TTS methods on Q8 KV,
# exact: self-consistency (Best-of-8 votes) through the direct path, and
# PRM beam search (width 2 x expand 4, 4 scoring boundaries of 8 tokens)
# through the scheduler's beam request class and through the direct
# path.  Each entry: (kv, impl, serve arguments, requests, samples each).
BASE_ARGS = ["--arch", "qwen2.5-1.5b", "--quantize", "--paged"]
BEAM_ARGS = ["--kv-quant", "q8", "--method", "beam_search", "--tasks", "2",
             "--beam-width", "2", "--beam-expand", "4", "--beam-steps", "4",
             "--step-tokens", "8"]
SERVE_PATHS = {f"{kv}/{impl}": (kv, impl, SERVE_ARGS + ["--kv-quant", kv],
                                4, 8)
               for kv in ("q8", "q4", "none") for impl in ("exact", "lut")}
SERVE_PATHS["q8/prefix"] = ("q8", "exact", SERVE_ARGS + [
    "--kv-quant", "q8", "--prefix-cache", "--fewshot", "3"], 4, 8)
SERVE_PATHS["q4/prefix"] = ("q4", "exact", SERVE_ARGS + [
    "--kv-quant", "q4", "--prefix-cache", "--fewshot", "3", "--budget", "1",
    "--tasks", "8"], 8, 1)
SERVE_PATHS["sc/direct"] = ("q8", "exact", BASE_ARGS + [
    "--kv-quant", "q8", "--method", "self_consistency", "--budget", "8",
    "--tasks", "2", "--max-tokens", "32"], 2, 8)
SERVE_PATHS["beam/sched"] = ("q8", "exact",
                             BASE_ARGS + BEAM_ARGS + ["--continuous"], 2, 2)
SERVE_PATHS["beam/direct"] = ("q8", "exact", BASE_ARGS + BEAM_ARGS, 2, 2)
# speculative decoding on Q8 KV, exact softmax, continuous Best-of-8 over
# 4 tasks x 48 tokens, all greedy: the plain scheduler (through
# controller.sweep with a greedy sampler: serve.py forces greedy only
# under --spec-k), then k = 4 self-drafting and k = 4 with the registry's
# dense draft model
SPEC_PATHS = ("spec/base", "spec/self", "spec/draft")
SERVE_PATHS["spec/base"] = ("q8", "exact", SERVE_ARGS + ["--kv-quant", "q8"],
                            4, 8)
SERVE_PATHS["spec/self"] = ("q8", "exact", SERVE_ARGS + [
    "--kv-quant", "q8", "--spec-k", "4", "--self-draft"], 4, 8)
SERVE_PATHS["spec/draft"] = ("q8", "exact", SERVE_ARGS + [
    "--kv-quant", "q8", "--spec-k", "4", "--draft-model", "qwen2.5-1.5b"],
    4, 8)
# olmoe-1b-7b at its published width (16 layers, 64 experts of width
# 1024, top-8), W4A16 (Q4 attention projections and expert gate/up, Q8
# expert down): continuous Best-of-8 over 2 tasks x 48 tokens on Q8 KV
# with exact softmax, Q4 KV with the LUT softmax, and Q8 KV with the
# prefix cache over a shared 3-shot header (the second task's group hits)
MOE_ARGS = ["--arch", MOE_ARCH, "--quantize", "--method", "best_of_n",
            "--budget", "8", "--tasks", "2", "--continuous", "--paged"]
MOE_PATHS = ("moe/q8", "moe/q4lut", "moe/prefix")
SERVE_PATHS["moe/q8"] = ("q8", "exact", MOE_ARGS + ["--kv-quant", "q8"],
                         2, 8)
SERVE_PATHS["moe/q4lut"] = ("q4", "lut", MOE_ARGS + ["--kv-quant", "q4"],
                            2, 8)
SERVE_PATHS["moe/prefix"] = ("q8", "exact", MOE_ARGS + [
    "--kv-quant", "q8", "--prefix-cache", "--fewshot", "3"], 2, 8)
# stablelm-3b at its published width (32 layers, d_model 2560, 32 heads of
# 80 with 32 KV heads, d_ff 6912, vocab 50304), W4A16, on Q4 KV (40-byte
# code rows: K2 and K4 in 4-byte chunks), exact softmax, continuous
# Best-of-8 over 2 tasks with the prefix cache over a 3-shot header (the
# second task's group hits, so K4 runs at its geometry too)
STABLELM_ARGS = ["--arch", "stablelm-3b", "--quantize", "--method",
                 "best_of_n", "--budget", "8", "--tasks", "2", "--continuous",
                 "--paged", "--kv-quant", "q4", "--prefix-cache", "--fewshot",
                 "3"]
SERVE_PATHS["q4/stablelm"] = ("q4", "exact", STABLELM_ARGS, 2, 8)
# dense rows (no --paged; "dense" below), Best-of-8 over 2 tasks x 48
# tokens: zamba2-1.2b at its published width (38 Mamba2 layers, d_model
# 2048, d_state 64, head_dim 64; the shared attention + SwiGLU block, 32
# heads of 64 and d_ff 8192, after every 6th layer; vocab 32000), W4A16,
# through the scheduler (ssm/zamba2) and the direct path
# (ssm/zamba2-direct); mamba2-130m (24 layers, d_model 768, d_state 128)
# in bf16, which has no W4A16 form (its in_proj does not tile), so no
# kernel runs (ssm/mamba2); and qwen2.5-1.5b W4A16 through the scheduler
# over dense rows (dense/bf16: K3 only, no K1/K2)
SSM_ARCH = "zamba2-1.2b"
SSM_ARGS = ["--arch", SSM_ARCH, "--quantize", "--method", "best_of_n",
            "--budget", "8", "--tasks", "2"]
DENSE_PATHS = ("ssm/zamba2", "ssm/zamba2-direct", "ssm/mamba2",
               "dense/bf16")
SERVE_PATHS["ssm/zamba2"] = ("dense", "exact", SSM_ARGS + ["--continuous"],
                             2, 8)
SERVE_PATHS["ssm/zamba2-direct"] = ("dense", "exact", SSM_ARGS, 2, 8)
SERVE_PATHS["ssm/mamba2"] = ("dense", "exact", [
    "--arch", "mamba2-130m", "--method", "best_of_n", "--budget", "8",
    "--tasks", "2", "--continuous"], 2, 8)
SERVE_PATHS["dense/bf16"] = ("dense", "exact", [
    "--arch", "qwen2.5-1.5b", "--quantize", "--method", "best_of_n",
    "--budget", "8", "--tasks", "2", "--continuous"], 2, 8)
# the largest logit gap, in the spec/base run, between the token it chose
# and the token a speculative path chose at a row's first divergence: a
# near-tie flipped by the verify's other arithmetic (chunked attention
# over the K4-dequantized prefix, K3 at M = 8 W) lies far below it
SPEC_GAP = 0.1
TOPK = 16  # base-run logits kept per row and step for the gap
# the autotune phase's served A/Bs, greedy serves with the empty cache
# every other phase runs against (untuned) and with the tuned one:
# spec/base's qwen2.5-1.5b Best-of-8 over 4 tasks on Q8 KV, untuned then
# tuned, and ssm/zamba2's zamba2-1.2b Best-of-8 over 2 tasks on dense
# rows, untuned, tuned, tuned, untuned (its tuned launches differ)
AUTOTUNE_AB = {
    "autotune/untuned": ("spec/base", "autotune/tuned", 1),
    "autotune/zamba2/untuned": ("ssm/zamba2", "autotune/zamba2/tuned", 2)}
AUTOTUNE_PATHS = tuple(p for base, (_, tuned, _) in AUTOTUNE_AB.items()
                       for p in (base, tuned))
GREEDY_PATHS = ("spec/base",) + AUTOTUNE_PATHS
TOKEN_PATHS = SPEC_PATHS + AUTOTUNE_PATHS
TOP_PATHS = ("spec/base",) + tuple(AUTOTUNE_AB)


def greedy_serve(argv: list) -> list:
    """``serve.main``'s continuous path with a greedy sampler and no
    speculation (the spec/base path): build the engine, sweep, check the
    pool drained.  Returns the sweep's rows."""
    import torch

    from repro_torch.core import reward as R
    from repro_torch.core.controller import sweep
    from repro_torch.data import tasks as T
    from repro_torch.launch import serve
    from repro_torch.serving.sampler import SamplerConfig

    args = serve.parse_args(argv)
    engine, tok = serve.build_engine(args)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    rows = sweep(engine, tok, T.gen_dataset(123, args.tasks),
                 [serve.spec_of(args)], gen, R.OracleVerifier(),
                 continuous=True, n_slots=args.slots,
                 sc=SamplerConfig(greedy=True))
    if engine.pool is not None and engine.pool.blocks_in_use:
        raise AssertionError(f"spec/base: {engine.pool.blocks_in_use} "
                             f"blocks in use after drain")
    return rows


def spec_parity(spec: dict, eos_id: int, base: str = "spec/base",
                paths: tuple = SPEC_PATHS[1:]) -> None:
    """Hold each of ``paths``' greedy tokens against ``base``'s (by
    default each speculative path against spec/base): the share of
    identical rows, and at each row's first divergence the base run's
    logit gap between its token and the path's (from the base run's
    top-``TOPK`` logits of that row and position).  Fails if a gap exceeds
    ``SPEC_GAP`` or the path's token is not among the base's top
    ``TOPK``."""
    base_path, base = base, spec[base]
    for path in paths:
        got = spec[path]["tokens"]
        same, divs = 0, []
        for key, want in sorted(base["tokens"].items()):
            have = got[key]
            if have == want:
                same += 1
                continue
            p = next((i for i, (a, b) in enumerate(zip(want, have))
                      if a != b), min(len(want), len(have)))
            a = want[p] if p < len(want) else eos_id
            b = have[p] if p < len(have) else eos_id
            vals, idx = base["top"][key + (p,)]
            gap = None
            if b in idx:
                gap = vals[idx.index(a)] - vals[idx.index(b)]
            divs.append({"req": key[0], "sample": key[1], "pos": p,
                         "base_token": a, "spec_token": b, "base_gap": gap})
        emit("spec_parity", path=path, base=base_path,
             rows=len(base["tokens"]),
             identical_rows=same, share=same / len(base["tokens"]),
             divergences=divs, bound=SPEC_GAP)
        bad = [d for d in divs if d["base_gap"] is None
               or d["base_gap"] > SPEC_GAP]
        if bad:
            raise AssertionError(f"{path}: diverges from {base_path} beyond "
                                 f"a near-tie (gap > {SPEC_GAP}): {bad}")


def dense_cache_bytes(engine, rows: int) -> int:
    """Bytes of ``rows`` dense cache rows of ``engine``'s model (a
    transformer's KV slots; a Mamba2 model's conv and f32 SSM states and
    the hybrid's shared-block KV), from the shapes alone."""
    cache = engine.model.init_cache(engine.cfg, rows, engine.max_len,
                                    device="meta")
    return sum(t.numel() * t.element_size() for t in cache.values())


def serve_runs(paths: dict | None = None) -> dict:
    """Drive the serve entry point once per path of ``paths`` (default
    ``SERVE_PATHS``).  Launch counts are reset
    just before and read just after each run, and kept per run, with the
    engine's prefill calls and decode steps recorded on their own (by
    wrapping ``DecodeEngine.prefill`` and ``DecodeEngine._step_core``,
    which every decode step of both the scheduler and the direct path
    runs).  Both routes are measured alike: a step's time is
    ``_step_core`` ended by a synchronize, decode tokens are the rows
    that step advances (not done, not frozen), and the serve's wall time
    runs from ``serve.build_engine``'s return to the serve's end.  The
    direct route's per-task results (``controller.run_method``) and its
    ``reorder`` calls are recorded to check that every task finished.
    The CUDA memory peak is reset once ``serve.build_engine`` returns, so
    ``peak_device_bytes`` covers serving and ``load_peak_device_bytes``
    the weights' random init and quantization.  The expected launch
    counts follow the served model (its layers, its Q4 projections per
    layer: ``gemm_layout``, its block size).

    Speculative paths: a round is ``ContinuousScheduler._spec_step``,
    timed to its end by a synchronize, its committed tokens the verify's
    (``DecodeEngine.spec_verify``, wrapped to record each round's B, W
    and prefix width); the target's snapshot steps inside a self-draft
    round count as draft steps, not decode steps, and the dense drafter's
    steps are counted apart (they launch no kernel).  The paths of
    ``GREEDY_PATHS`` serve through ``greedy_serve``; those of
    ``TOKEN_PATHS`` keep their tokens and those of ``TOP_PATHS`` each
    row's top-``TOPK`` logits per step, for ``spec_parity``.
    Returns ({path: {"counts": {wrapper: n}, "shapes": {(M, K, N): n},
    "kv_shapes": {(mode, R): n}, "kv_geom": (Hkv, D), "metrics": {...}}},
    {token path: {"tokens", "top"}, "eos_id": id})."""
    import numpy as np
    import torch

    from repro_torch.core import controller
    from repro_torch.kernels import lut_dequant_kv as LK
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import ContinuousScheduler, DecodeEngine

    runs, spec = {}, {}
    orig_prefill = DecodeEngine.prefill
    orig_step = DecodeEngine._step_core
    orig_build = serve.build_engine
    orig_reorder = DecodeEngine.reorder
    orig_run = controller.run_method
    orig_verify = DecodeEngine.spec_verify
    orig_round = ContinuousScheduler._spec_step
    orig_sched_run = ContinuousScheduler.run
    for path, (kv_quant, impl, args, n_req, n_samp) in (
            SERVE_PATHS if paths is None else paths).items():
        prefills = []  # (batch, padded width, partial?) per engine prefill
        steps = []     # (rows, seconds to the step's end) per decode step
        live = []      # rows each decode step advances (device scalars)
        reorders = [0]
        tasks = []     # (TTSResult, reorders) per direct-route task
        built = {}
        verifies = []  # (B, W, prefix width) per spec_verify
        rounds = []    # (committed tokens, seconds to the end) per round
        draft_steps = []   # rows of each target step inside a round
        drafter_steps = [0]  # the dense drafter's decode steps
        in_round = [False]
        scheds = []
        top = []       # spec/base: (rows' keys, top values, top ids)

        def recording(self, tokens, lengths=None, **kw):
            if self is built.get("engine"):  # not the dense drafter's
                prefills.append((*tokens.shape, kw.get("cached_table")
                                 is not None))
            return orig_prefill(self, tokens, lengths, **kw)

        def stepping(self, state, *a, **kw):
            if self is not built.get("engine"):
                drafter_steps[0] += 1
                return orig_step(self, state, *a, **kw)
            if in_round[0]:
                draft_steps.append(int(state.done.shape[0]))
                return orig_step(self, state, *a, **kw)
            t0 = time.perf_counter()
            out = orig_step(self, state, *a, **kw)
            torch.cuda.synchronize()
            steps.append((int(state.done.shape[0]),
                          time.perf_counter() - t0))
            live.append((~state.done).sum())
            if path in TOP_PATHS:
                t = torch.topk(state.pending_logits, TOPK, dim=-1)
                keys = {i: (s.req.req_id, s.sample_idx, len(s.tokens))
                        for i, s in enumerate(scheds[-1].slots)
                        if s is not None}
                top.append((keys, t.values, t.indices))
            return out

        def verifying(self, state, xs, *a, **kw):
            clen = state.cache_len[~state.done]
            pw = max(1, -(-int(clen.max()) // self.pool.block_size)) \
                if clen.numel() else 1
            verifies.append((*np.asarray(xs).shape, pw))
            return orig_verify(self, state, xs, *a, **kw)

        def round_(self, *a, **kw):
            in_round[0] = True
            t0 = time.perf_counter()
            try:
                out = orig_round(self, *a, **kw)
            finally:
                in_round[0] = False
            torch.cuda.synchronize()
            if out is not None:
                rounds.append((int(out[1].sum()), time.perf_counter() - t0))
            return out

        def sched_running(self, *a, **kw):
            scheds.append(self)
            return orig_sched_run(self, *a, **kw)

        def reordering(self, *a, **kw):
            reorders[0] += 1
            return orig_reorder(self, *a, **kw)

        def running(*a, **kw):
            before = reorders[0]
            res = orig_run(*a, **kw)
            tasks.append((res, reorders[0] - before))
            return res

        def building(a):
            engine, tok = orig_build(a)
            torch.cuda.synchronize()
            built["load_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            built["engine"] = engine
            built["t0"] = time.perf_counter()
            return engine, tok

        prev = L.set_paged_attention_impl(impl)
        DecodeEngine.prefill = recording
        DecodeEngine._step_core = stepping
        DecodeEngine.reorder = reordering
        DecodeEngine.spec_verify = verifying
        ContinuousScheduler._spec_step = round_
        ContinuousScheduler.run = sched_running
        controller.run_method = running
        serve.build_engine = building
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rows = (greedy_serve if path in GREEDY_PATHS
                    else serve.main)(args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = ops.launch_counts()
            shapes = ops.gemm_launches_by_shape()
            kv_shapes = dict(LK.lut_dequant_kv.shapes)
            peak = torch.cuda.max_memory_allocated()
        finally:
            DecodeEngine.prefill = orig_prefill
            DecodeEngine._step_core = orig_step
            DecodeEngine.reorder = orig_reorder
            DecodeEngine.spec_verify = orig_verify
            ContinuousScheduler._spec_step = orig_round
            ContinuousScheduler.run = orig_sched_run
            controller.run_method = orig_run
            serve.build_engine = orig_build
            L.set_paged_attention_impl(prev)
        row = rows[0]
        s = row.get("serving")
        pool = built["engine"].pool
        pinned = s.get("prefix_cache", {}).get("cached_blocks", 0) if s \
            else 0
        if pool is not None and pool.blocks_in_use != pinned:
            raise AssertionError(f"serve {path}: pool holds "
                                 f"{pool.blocks_in_use} blocks after drain, "
                                 f"expected the {pinned} cache-pinned")
        # every request completes: the scheduler's counts, or on the
        # direct path one result of n_samp completions per task, after one
        # prefill each; beam search reaches a scoring boundary (a prune
        # and expand) in every task
        beam = row["method"] == "beam_search"
        if s is not None:
            done_ok = (s["completed_requests"] == n_req
                       and s["completed_samples"] == n_req * n_samp
                       and len(steps) + len(rounds) == s["steps"]
                       and len(rounds) == len(verifies) == s["spec_rounds"]
                       and len(prefills) == s["prefill_calls"]
                       and (not beam or s["beam_boundaries"] >= n_req))
        else:
            done_ok = (len(prefills) == n_req and len(tasks) == n_req
                       and all(len(r.completions) == n_samp
                               and (not beam or n >= 1) for r, n in tasks))
        if not done_ok:
            raise AssertionError(
                f"serve {path}: not every request completed: {row}, "
                f"{len(prefills)} prefills, {len(steps)} steps, "
                f"{[(len(r.completions), n) for r, n in tasks]} "
                f"(completions, reorders) per direct task")
        partial = sum(1 for *_, p in prefills if p)
        if "--prefix-cache" in args and (s["prefix_cache_hits"] < 1
                                         or partial < 1):
            raise AssertionError(f"serve {path}: no prefix-cache hit")
        if path in SPEC_PATHS[1:] and not rounds:
            raise AssertionError(f"serve {path}: no speculative round")
        # a self-draft round runs W - 1 snapshot steps; the draft model's
        # rounds run none on the target (its drafter steps run apart)
        want_draft = sum(w - 1 for _, w, _ in verifies) \
            if path == "spec/self" else 0
        if len(draft_steps) != want_draft or (
                path == "spec/draft") != (drafter_steps[0] > 0):
            raise AssertionError(
                f"serve {path}: {len(draft_steps)} draft steps on the "
                f"target (expected {want_draft}), {drafter_steps[0]} on "
                f"the drafter")
        # on the paged pool one attention launch per layer per target
        # decode step (plain or draft), none on dense rows (the plain
        # layers.decode_attention, as the JAX package's XLA there); the
        # model's Q4 projections (gemm_layout, none unless --quantize) at
        # each (K, N) per target decode step (M = the step's rows: the
        # slots, or the direct path's batch), per prefill (M = batch x
        # padded width) and per verify (M = slots x W); two KV dequant
        # launches (K and V) per partial prefill and per verify, a
        # verify's at R = layers x slots x prefix width x block size
        cfg = built["engine"].cfg
        n_layers = cfg.n_layers
        bs = pool.block_size if pool is not None else 0
        attn = "paged_attention" if kv_quant == "none" else \
            "quant_paged_attention"
        want = {"paged_attention": 0, "quant_paged_attention": 0,
                "lut_dequant_kv": 2 * (partial + len(verifies)),
                # K5 and K6 are off the served path, as in the JAX package
                "lut_softmax_attention": 0, "tile_quantize": 0}
        if pool is not None:
            want[attn] = n_layers * (len(steps) + len(draft_steps))
        layout = gemm_layout(cfg) if "--quantize" in args else {}
        for (k, n), per_fwd in layout.items():
            for m in ([rows_ for rows_, _ in steps] + draft_steps
                      + [b * width for b, width, _ in prefills]
                      + [b * w for b, w, _ in verifies]):
                want[(m, k, n)] = want.get((m, k, n), 0) + per_fwd
        want["lut_dequant_gemm"] = sum(n for key, n in want.items()
                                       if isinstance(key, tuple))
        want_kv = {}
        for b, _, pw in verifies:
            key = (kv_quant, n_layers * b * pw * bs)
            want_kv[key] = want_kv.get(key, 0) + 2
        got = {**counts, **shapes}
        if any(got.get(key, 0) != n for key, n in want.items()) or \
                counts["lut_dequant_gemm"] != sum(shapes.values()) or \
                (verifies and kv_shapes != want_kv):
            raise AssertionError(f"serve {path}: launches {got} "
                                 f"{kv_shapes}, expected {want} {want_kv}")
        runs[path] = {"counts": counts, "shapes": shapes,
                      "kv_shapes": kv_shapes,
                      "kv_geom": (cfg.n_kv_heads, cfg.resolved_head_dim())}
        if path in TOKEN_PATHS:
            spec[path] = {"tokens": {
                (smp.req_id, smp.sample_idx): list(smp.tokens)
                for smps in scheds[-1].completed.values() for smp in smps}}
            spec[path]["top"] = {
                keys[i]: (v.tolist(), ix.tolist())
                for keys, vals, ids in top
                for i, v, ix in zip(range(vals.shape[0]), vals.cpu(),
                                    ids.cpu()) if i in keys}
            spec["eos_id"] = built["engine"].eos_id
        wall_s = t1 - built["t0"]
        # decode tokens: rows each plain step advances plus the tokens
        # each speculative round committed; a step's time is a plain
        # step's or a whole round's
        decode = (int(torch.stack(live).sum()) if live else 0) + \
            sum(c for c, _ in rounds)
        step_s = np.array([dt for _, dt in steps] + [dt for _, dt in rounds])
        p50, p99 = (float(np.percentile(step_s, q)) for q in (50, 99))
        runs[path]["metrics"] = {
            "decode_tok_per_s": decode / wall_s if wall_s > 0 else 0.0,
            "step_time_p50_ms": p50 * 1e3, "step_time_p99_ms": p99 * 1e3,
            "steps": len(steps), "prefill_calls": len(prefills)}
        emit("serve", path=path, arch=cfg.name, kv_quant=kv_quant, impl=impl,
             method=row["method"],
             route="scheduler" if s is not None else "direct",
             accuracy=row["accuracy"], decode_tokens=decode,
             direct_reorders=[n for _, n in tasks],
             steps=len(steps), step_rows=sorted({r for r, _ in steps}),
             prefill_calls=len(prefills), partial_prefills=partial,
             prefill_widths=sorted({b * w for b, w, _ in prefills}),
             decode_tok_per_s=decode / wall_s if wall_s > 0 else 0.0,
             step_time_p50_ms=p50 * 1e3, step_time_p99_ms=p99 * 1e3,
             serve_wall_s=wall_s, main_wall_s=t1 - t0,
             peak_device_bytes=peak,
             load_peak_device_bytes=built["load_peak"],
             **(dict(peak_kv_bytes=pool.stats()["peak_bytes_in_use"],
                     pool_reserved_bytes=pool.stats()["pool_reserved_bytes"])
                if pool is not None else dict(
                    dense_cache_bytes=dense_cache_bytes(
                        built["engine"], max(r for r, _ in steps)))),
             launches=counts,
             gemm_launches={"x".join(map(str, k)): v
                            for k, v in sorted(shapes.items())},
             dequant_kv_launches={f"{m}/R{r}": v
                                  for (m, r), v in sorted(kv_shapes.items())},
             attn_launches_per_decode_step=counts[attn] / max(
                 1, len(steps) + len(draft_steps)),
             # K3 per decode step, prefill and verify (checked above)
             k3_launches_per_forward=sum(layout.values()),
             **({} if not rounds else dict(
                 spec_rounds=len(rounds), plain_steps=len(steps),
                 draft_steps=len(draft_steps),
                 drafter_steps=drafter_steps[0],
                 verify_widths=sorted({w for _, w, _ in verifies}),
                 verify_prefix_widths=sorted({pw for *_, pw in verifies}),
                 committed_per_round=sum(c for c, _ in rounds) / len(rounds),
                 round_time_p50_ms=float(np.percentile(
                     [dt for _, dt in rounds], 50)) * 1e3,
                 spec_acceptance_rate=s["spec_acceptance_rate"],
                 accepted_tokens_per_step=s["accepted_tokens_per_step"])),
             **({} if s is None else dict(
                 prefill_tokens=s["prefill_tokens"],
                 prefill_tokens_saved=s["prefill_tokens_saved"],
                 prefill_calls_per_request=s["prefill_calls_per_request"],
                 admission_batch_max=s["admission_batch_max"],
                 prefix_cache_hits=s["prefix_cache_hits"],
                 cache_pinned_blocks=pinned,
                 preemptions=s["preemptions"],
                 beam_boundaries=s["beam_boundaries"],
                 prm_batches=s["prm_batches"],
                 # slots a lane held per step, frozen beam lanes included
                 sched_slot_steps=s["decode_tokens"],
                 sched_peak_kv_bytes=s["peak_kv_bytes"])))
    return runs, spec


# ---------------------------------------------------------------------------
# whisper-base on the dense engine, and training with the checkpointer
# ---------------------------------------------------------------------------

# whisper-base at its published width (6 + 6 layers, d_model 512, 8 heads
# of 64, d_ff 2048, 1500 frames, vocab 51865), W4A16, bf16 compute, seed 0:
# the JAX package's serving path for it, DecodeEngine.prefill(tokens,
# lengths, embeddings=frames) on dense rows, fork, generate
WHISPER_ARCH = "whisper-base"
WHISPER_CLIPS, WHISPER_PROMPT, WHISPER_FORK, WHISPER_TOKENS = 2, 4, 4, 48


def whisper_run(dev: str = "cuda") -> dict:
    """Serve whisper-base once: 2 clips of random frames (1500, 512) with
    4-token prompts prefilled on dense rows, forked x 4 to 8 rows, 48
    tokens sampled (the default sampler, seeded).  Launch counts are
    reset just before the prefill and read just after the last step: K3
    exactly ``encoder_gemm_layout`` at M = clips x 1500 plus
    ``gemm_layout`` at M = clips x prompt per prefill, and ``gemm_layout``
    at M = 8 per decode step; no other kernel.  Every row must finish (48
    tokens or a stop) with finite logits.  Reports decode tok/s (rows
    advanced per step over the wall from the engine's build), step p50 /
    p99 (``DecodeEngine._step_core`` ended by a synchronize), prefill ms,
    the serving and load peaks and ``dense_cache_bytes``.  Returns the
    run's {"counts", "shapes", "kv_shapes", "kv_geom"}."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import whisper as W
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving.engine import DecodeEngine

    cfg = get_config(WHISPER_ARCH)
    tok = ByteTokenizer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = cast_params(quantize_model_params(W.init_params(
        cfg, seed=0, device=dev)), getattr(torch, cfg.dtype))
    engine = DecodeEngine(params, cfg, max_len=256, eos_id=tok.eos_id,
                          pad_id=tok.pad_id)
    torch.cuda.synchronize()
    load_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((WHISPER_CLIPS, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device=dev)
    prompts = torch.randint(3, 259, (WHISPER_CLIPS, WHISPER_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    steps = []
    orig_step = DecodeEngine._step_core

    def stepping(self, state, *a, **kw):
        t0 = time.perf_counter()
        out = orig_step(self, state, *a, **kw)
        torch.cuda.synchronize()
        steps.append((int((~state.done).sum()), time.perf_counter() - t0))
        return out

    DecodeEngine._step_core = stepping
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st = engine.prefill(prompts, None, frames)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        st = engine.fork(st, WHISPER_FORK)
        st, toks = engine.generate(st, WHISPER_TOKENS, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = ops.launch_counts()
        shapes = ops.gemm_launches_by_shape()
    finally:
        DecodeEngine._step_core = orig_step
    rows = WHISPER_CLIPS * WHISPER_FORK
    want = {}
    for layout, m, n in (
            (encoder_gemm_layout(cfg), WHISPER_CLIPS * cfg.encoder_seq_len,
             1),
            (gemm_layout(cfg), WHISPER_CLIPS * WHISPER_PROMPT, 1),
            (gemm_layout(cfg), rows, len(steps))):
        for (k, nn), per in layout.items():
            want[(m, k, nn)] = want.get((m, k, nn), 0) + per * n
    others = {k: v for k, v in counts.items() if k != "lut_dequant_gemm"}
    if len(steps) != WHISPER_TOKENS or shapes != want or any(
            others.values()) or counts["lut_dequant_gemm"] != sum(
            want.values()):
        raise AssertionError(f"encdec/whisper: {len(steps)} steps, launches "
                             f"{counts} {shapes}, expected {want}")
    n_gen = st.n_gen.cpu()
    finished = bool(((n_gen == WHISPER_TOKENS) | st.done.cpu()).all())
    if not finished or not bool(torch.isfinite(st.pending_logits).all()):
        raise AssertionError(f"encdec/whisper: rows not finished or "
                             f"non-finite logits (n_gen {n_gen.tolist()})")
    if tuple(toks.shape) != (rows, WHISPER_TOKENS):
        raise AssertionError(f"encdec/whisper: tokens {tuple(toks.shape)}")
    step_s = np.array([dt for _, dt in steps])
    decode = sum(r for r, _ in steps)
    wall = t1 - t_build
    cache_bytes = sum(
        t.numel() * t.element_size() for t in W.init_cache(
            cfg, rows, engine.max_len, t_enc=cfg.encoder_seq_len,
            device="meta").values())
    emit("serve", path="encdec/whisper", arch=cfg.name, kv_quant="dense",
         impl="exact", method="prefill_fork_generate", route="engine",
         clips=WHISPER_CLIPS, frames=cfg.encoder_seq_len,
         prompt=WHISPER_PROMPT, rows=rows, steps=len(steps),
         decode_tokens=decode, decode_tok_per_s=decode / wall,
         step_time_p50_ms=float(np.percentile(step_s, 50)) * 1e3,
         step_time_p99_ms=float(np.percentile(step_s, 99)) * 1e3,
         prefill_ms=prefill_ms, serve_wall_s=wall,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         load_peak_device_bytes=load_peak, dense_cache_bytes=cache_bytes,
         finished_rows=int(((n_gen == WHISPER_TOKENS)
                            | st.done.cpu()).sum()),
         launches=counts,
         gemm_launches={"x".join(map(str, k)): v
                        for k, v in sorted(shapes.items())},
         k3_launches_per_prefill=sum(gemm_layout(cfg).values()) + sum(
             encoder_gemm_layout(cfg).values()),
         k3_launches_per_step=sum(gemm_layout(cfg).values()))
    del engine, params, st
    torch.cuda.empty_cache()
    return {"counts": counts, "shapes": shapes, "kv_shapes": {},
            "kv_geom": (cfg.n_kv_heads, cfg.resolved_head_dim())}


# ---------------------------------------------------------------------------
# long: a 32k-token prompt of qwen2.5-1.5b through the chunked attention
# ---------------------------------------------------------------------------

LONG_ARCH = "qwen2.5-1.5b"
LONG_PROMPT, LONG_STEPS, LONG_BLOCK = 32704, 64, 16
# the cache reaches LONG_PROMPT + LONG_STEPS = 32768 positions; the engine
# keeps its last slot as scratch, so one block more
LONG_MAX_LEN = 32768 + LONG_BLOCK
# the last prompt position's logits of the full prefill (attention over
# the prompt's bf16 K/V, in chunks; every product at M 32,704) against
# those of a prefill of one token fewer and one decode step (every
# product at M 1), over the Q8 pool (K2) and over a bf16 pool (K1, which
# holds the prefill's K/V exactly): every element within this share of
# the logits' largest magnitude.  The two routes round their bf16
# products differently, which 28 layers of random weights grow to a few
# percent of the largest logit, so an argmax may differ only where the
# full prefill's top-2 gap is at most SPEC_GAP, the rule every other path
# of this script holds differently rounded runs to.
LONG_LOGIT_RTOL = 0.05


def _long_cost(cfg) -> dict:
    """The chunked attention's working set (bytes) at the prompt's shapes
    (``layers.chunked_attention_workspace``) and the scores a prefill
    over all of it at once would hold: (Hq, S, S) f32 per row."""
    import torch

    from repro_torch.models import layers as L

    hd = cfg.resolved_head_dim()
    q = torch.empty((1, LONG_PROMPT, cfg.n_heads, hd), device="meta")
    k = torch.empty((1, LONG_PROMPT, cfg.n_kv_heads, hd), device="meta")
    geo = L._Geometry(q, k, 512, 1024)
    return {"attention_working_set_bytes":
            L.chunked_attention_workspace(geo, 2),
            "unchunked_scores_bytes": cfg.n_heads * LONG_PROMPT ** 2 * 4,
            "tiles_per_layer": geo.tiles(True, True),
            "tiles_unskipped": geo.nq * geo.nkv}


def long_phase(dev: str = "cuda") -> dict:
    """qwen2.5-1.5b at its published width, W4A16 under ``DEFAULT_POLICY``,
    on a Q8 paged pool (16-token blocks): one prompt of ``LONG_PROMPT``
    random seed-0 tokens prefilled through ``DecodeEngine`` (the chunked
    attention: one (1, 2, 6, 512, 1024) score tile at a time), then
    ``LONG_STEPS`` greedy steps, which fill the cache to 32,768 positions
    (K2 over up to 2,048 blocks a row).  Launches exact: 168 K3 at M =
    ``LONG_PROMPT`` in the prefill, 28 K2 and 168 K3 at M 1 a step.  Then
    the self-consistency check: a prefill of the first ``LONG_PROMPT`` -
    1 tokens and one decode step with the last one give the last prompt
    position's logits again, over the Q8 pool (K2) and over a bf16 pool
    (K1): within ``LONG_LOGIT_RTOL``, the argmax equal or the full
    prefill's top-2 gap at most ``SPEC_GAP``.  The parent commit cannot run this: its prefill holds the (12, S, S) f32
    scores, 47.8 GiB, and their exp.  Returns the run's {"counts",
    "shapes", ...} (prefill and steps; the check's launches apart)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TM
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config(LONG_ARCH)
    torch.cuda.empty_cache()
    params = cast_params(quantize_model_params(
        TM.init_params(cfg, seed=0, device=dev)), getattr(torch, cfg.dtype))
    torch.cuda.empty_cache()
    eng = DecodeEngine(params, cfg, max_len=LONG_MAX_LEN, paged=True,
                       block_size=LONG_BLOCK, kv_quant="q8",
                       n_blocks=1 + 2 * (LONG_MAX_LEN // LONG_BLOCK))
    toks = torch.randint(3, cfg.vocab_size, (1, LONG_PROMPT),
                         generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([LONG_PROMPT], dtype=torch.int32)
    layout = gemm_layout(cfg)
    others = ("paged_attention", "lut_dequant_kv", "lut_softmax_attention",
              "tile_quantize")

    def check(what, counts, shapes, want_shapes, k2):
        bad = shapes != want_shapes or counts["quant_paged_attention"] != k2 \
            or any(counts[k] for k in others)
        if bad:
            raise AssertionError(f"long/{what}: launches {counts} "
                                 f"{shapes}, want {want_shapes} and {k2} K2")

    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st = eng.prefill(toks, lens)
        full = st.pending_logits[0].float().clone()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_peak = torch.cuda.max_memory_allocated()
        counts, shapes = ops.launch_counts(), ops.gemm_launches_by_shape()
        check("prefill", counts, shapes,
              {(LONG_PROMPT, K, N): n for (K, N), n in layout.items()}, 0)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, out = eng.generate(st, LONG_STEPS, None,
                               SamplerConfig(greedy=True))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_peak = torch.cuda.max_memory_allocated()
        dcounts, dshapes = ops.launch_counts(), ops.gemm_launches_by_shape()
        check("decode", dcounts, dshapes,
              {(1, K, N): n * LONG_STEPS for (K, N), n in layout.items()},
              cfg.n_layers * LONG_STEPS)
        cache_len = int(st.cache_len[0])
        if cache_len != LONG_PROMPT + LONG_STEPS or not bool(
                (out >= 0).all()):
            raise AssertionError(f"long: cache at {cache_len}, tokens "
                                 f"{out.tolist()}")
        table_w = int(st.n_blocks[0])
        eng.release_rows(st, [0])
        # one token fewer, then the last prompt token through one step,
        # over the Q8 pool (K2) and over a bf16 pool (K1)
        q8 = _long_self_check(eng, toks, lens, dev, layout, check, "q8")
        del eng
        torch.cuda.empty_cache()
        fp_eng = DecodeEngine(params, cfg, max_len=LONG_MAX_LEN, paged=True,
                              block_size=LONG_BLOCK,
                              n_blocks=1 + LONG_MAX_LEN // LONG_BLOCK)
        fp = _long_self_check(fp_eng, toks, lens, dev, layout, check, "none")
        del fp_eng
    top2 = torch.topk(full, 2).values
    gap = float(top2[0] - top2[1])
    scale = float(full.abs().max())
    for name, (sc, _) in (("q8", q8), ("none", fp)):
        if not (torch.isfinite(sc).all() and torch.isfinite(full).all()):
            raise AssertionError(f"long/{name}: non-finite logits")
    q8_diff = float((q8[0] - full).abs().max())
    fp_diff = float((fp[0] - full).abs().max())
    q8_same = int(torch.argmax(q8[0])) == int(torch.argmax(full))
    fp_same = int(torch.argmax(fp[0])) == int(torch.argmax(full))
    ok = max(q8_diff, fp_diff) <= LONG_LOGIT_RTOL * scale and (
        (q8_same and fp_same) or gap <= SPEC_GAP)
    from repro_torch.kernels import paged_attention as PA

    emit("long", arch=cfg.name, layers=cfg.n_layers, prompt=LONG_PROMPT,
         steps=LONG_STEPS, cache_len=cache_len, table_blocks=table_w,
         kv_quant="q8", prefill_ms=prefill_ms,
         decode_tok_per_s=LONG_STEPS / decode_s,
         decode_step_ms=decode_s / LONG_STEPS * 1e3,
         base_device_bytes=base, prefill_peak_device_bytes=prefill_peak,
         decode_peak_device_bytes=decode_peak,
         k2_splits=PA.splits(1, cfg.n_kv_heads, LONG_MAX_LEN // LONG_BLOCK),
         largest_logit=scale, top2_gap=gap,
         check_q8={"max_abs_diff": q8_diff, "tol": LONG_LOGIT_RTOL * scale,
                   "argmax_equal": q8_same, "launches": q8[1]},
         check_bf16={"max_abs_diff": fp_diff, "tol": LONG_LOGIT_RTOL * scale,
                     "argmax_equal": fp_same, "launches": fp[1]},
         prefill_launches=counts, decode_launches=dcounts,
         **_long_cost(cfg))
    if not ok:
        raise AssertionError(f"long: the last prompt position's logits: Q8 "
                             f"{q8_diff} (argmax equal {q8_same}), bf16 "
                             f"{fp_diff} (argmax equal {fp_same}); largest "
                             f"{scale}, top-2 gap {gap}")
    del params, st
    torch.cuda.empty_cache()
    total = {k: counts[k] + dcounts[k] for k in counts}
    merged = dict(shapes)
    for k, n in dshapes.items():
        merged[k] = merged.get(k, 0) + n
    return {"counts": total, "shapes": merged, "kv_shapes": {},
            "kv_geom": (cfg.n_kv_heads, cfg.resolved_head_dim())}


def _long_self_check(eng, toks, lens, dev, layout, check, kv: str):
    """A prefill of the prompt but its last token, then one decode step
    with that token: (the step's f32 logits, its launches).  Exactly 168
    K3 at M ``LONG_PROMPT`` - 1 and 168 at M 1, and 28 launches of the
    pool's paged attention (K2 on Q8, K1 on bf16)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    st = eng.prefill(toks[:, :-1], lens - 1)
    st = eng.prepare_decode(st)
    tok = toks[:, -1].to(dev).int()
    logits = eng._decode(tok, eng._cache(st), st.cache_len + 1,
                         st.done)[0].float()
    counts, shapes = ops.launch_counts(), ops.gemm_launches_by_shape()
    want = {(LONG_PROMPT - 1, K, N): n for (K, N), n in layout.items()}
    want.update({(1, K, N): n for (K, N), n in layout.items()})
    n_layers = eng.cfg.n_layers
    if kv == "none":
        if counts["paged_attention"] != n_layers:
            raise AssertionError(f"long/check/bf16: launches {counts}")
        counts = dict(counts, paged_attention=0)
        check("check/bf16", counts, shapes, want, 0)
    else:
        check("check/q8", counts, shapes, want, n_layers)
    eng.release_rows(st, [0])
    return logits, ops.launch_counts()


def long_paged_case(seed: int):
    """K2 at the ``long`` path's decode geometry: one row, Hkv 2, G 6, D
    128, a Q8 pool of 16-token blocks, the table's 2,049 blocks, the
    cache at 32,768 positions."""
    import torch

    from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

    Hkv, G, D, bs = 2, 6, 128, LONG_BLOCK
    W = LONG_MAX_LEN // bs
    n = LONG_PROMPT + LONG_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((1, Hkv, G, D), generator=gen, device="cuda")
         * 0.5).to(torch.bfloat16)
    gr, gc = kv_tile_geometry(Hkv, D)
    pools = [quantize_kv(torch.randn((1 + W, bs, Hkv, D), generator=gen,
                                     device="cuda") * 0.5, mode="q8",
                         gr=gr, gc=gc) for _ in range(2)]
    table = (torch.randperm(W, generator=torch.Generator().manual_seed(
        seed)) + 1).int()[None].cuda()
    return q, pools[0], pools[1], table, torch.tensor([n], dtype=torch.int32,
                                                      device="cuda")


def check_long_paged(results: list) -> None:
    """K2 (exact softmax) at the ``long`` path's geometry against its plain
    version (2e-5 f32 and bf16 with one bf16 step), timed in bf16 beside
    its bound, the plain version and SDPA over the gathered cache."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    plain = plain_fn("exact")
    cb = ops.q4_codebook("cuda")
    q, kp, vp, table, lens = long_paged_case(11)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        qq = q.to(dtype)
        out = PA.quant_paged_attention(qq, kp, vp, table, lens, None, cb,
                                       window=0, exp_mode="exact")
        want = plain(qq, kp, vp, table, lens, None, 0)
        torch.cuda.synchronize()
        rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
        errs.append(check_close(f"quant_paged_attention/long/{dtype}", out,
                                want, 2e-5, rtol))
    run = lambda: PA.quant_paged_attention(q, kp, vp, table, lens, None,  # noqa: E731
                                           cb, exp_mode="exact")
    nbytes, flops = paged_bytes_flops(q, kp, table, lens, 0)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row = {"name": "quant_paged_attention/q8/exact/long", "route": "cuda",
           "source": PAGED_SRC, "replaces": REPLACES["quant_paged_attention"],
           "max_abs_err": max(errs), "ms": time_ms(run), "call_ms":
           call_ms(run), "plain_ms": time_ms(
               lambda: plain(q, kp, vp, table, lens, None, 0), iters=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": sdpa_library(q, kp, vp, table, lens),
           "splits": PA.splits(*q.shape[:2], table.shape[1]),
           "counter": "quant_paged_attention", "path": "long"}
    emit("kernel", **row, shape=f"B1 Hkv2 G6 D128 bs16 W{table.shape[1]} "
         f"len{int(lens[0])}", dtype="bfloat16")
    results.append(row)


TRAIN_ARGS = ["--arch", "qwen2.5-1.5b", "--steps", "6", "--batch", "8",
              "--seq", "128"]
# the resume chain: 4 layers of the same widths, a checkpoint every 2
# steps, relaunched from 4 to 6
CHAIN_LAYERS = 4
CHAIN_ARGS = ["--arch", "qwen2.5-1.5b", "--batch", "8", "--seq", "128",
              "--ckpt-every", "2"]
# train_4k's sequence length at qwen2.5-1.5b's published width: 2 rows x
# 4096 tokens, 3 steps; the predictions written before the first card run
TRAIN_4K_ARGS = ["--arch", "qwen2.5-1.5b", "--steps", "3", "--batch", "2",
                 "--seq", "4096", "--log-every", "1"]
TRAIN_4K_PREDICTED = {"step_ms": 1500.0, "peak_device_bytes": 40e9}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _unchanged_leaves(res, dev) -> list:
    """Param leaves of a ``launch.train`` run equal to their init (the
    key biases' grad is zero in exact arithmetic); any other raises."""
    import torch

    from repro_torch import tree as T
    from repro_torch.models import api

    cfg = res["cfg"]
    vals = res["losses"] + res["grad_norms"]
    if not all(map(math.isfinite, vals)):
        raise AssertionError(f"train: losses {res['losses']} grad norms "
                             f"{res['grad_norms']}")
    init = api.get_model(cfg).init_params(cfg, seed=0, device=dev)
    unchanged = [p for (p, a, _), (_, b, _) in zip(
        T.stacked_leaves(res["state"]["params"]), T.stacked_leaves(init))
        if all(torch.equal(x, y) for x, y in zip(a, b))]
    del init
    if any(not p.endswith("wk/b") for p in unchanged):
        raise AssertionError(f"train: params unchanged: {unchanged}")
    return unchanged


def train_4k_run(dev: str = "cuda") -> None:
    """``launch.train`` at train_4k's sequence length (``TRAIN_4K_ARGS``):
    finite losses and grad norms, every leaf but the key biases changed;
    step ms and peak bytes beside ``TRAIN_4K_PREDICTED``.  Its attention
    runs the chunked loop, forward and (recomputing each tile) backward,
    under remat."""
    import numpy as np
    import torch

    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    on = [] if dev == "cuda" else ["--device", dev]
    res = train.main(TRAIN_4K_ARGS + on)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if len(res["losses"]) != 3:
        raise AssertionError(f"train_4k: {len(res['losses'])} steps")
    unchanged = _unchanged_leaves(res, dev)
    batch, seq = (int(TRAIN_4K_ARGS[TRAIN_4K_ARGS.index(f) + 1])
                  for f in ("--batch", "--seq"))
    after = np.array(res["step_s"][1:]) * 1e3
    emit("train_4k", args=TRAIN_4K_ARGS, losses=res["losses"],
         grad_norms=res["grad_norms"],
         step_ms=[x * 1e3 for x in res["step_s"]],
         step_ms_p50_after_first=float(np.percentile(after, 50)),
         tokens_per_s=batch * seq * 1e3 / float(np.percentile(after, 50)),
         peak_device_bytes=peak, predicted=TRAIN_4K_PREDICTED,
         unchanged_leaves=unchanged)
    del res
    torch.cuda.empty_cache()


def train_phase(dev: str = "cuda") -> dict:
    """``repro_torch.launch.train`` at qwen2.5-1.5b's published width (28
    layers, d_model 1536, vocab 151936; bf16 compute, f32 master params,
    remat full), 6 steps of batch 8 x 128 tokens: every loss and grad norm
    finite, every param leaf changed but the key biases (whose grad is
    zero in exact arithmetic).  Then the trained params saved as a
    params-only checkpoint and restored (bit-equal), each timed;
    ``serve --ckpt`` from it, W4A16, continuous Best-of-8 over 2 tasks on
    Q8 KV, every request complete; then the resume chain at 4 layers:
    ``--steps 4 --ckpt-every 2``, relaunched to ``--steps 6``, which must
    resume at step 4.  Everything is written under a temp dir, removed at
    the end.  Returns the serve run's {"counts", "shapes", ...}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import api

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        on = [] if dev == "cuda" else ["--device", dev]
        res = train.main(TRAIN_ARGS + on)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cfg = res["cfg"]
        if len(res["losses"]) != 6:
            raise AssertionError(f"train: losses {res['losses']}")
        unchanged = _unchanged_leaves(res, dev)
        params = res["state"]["params"]
        step_s = np.array(res["step_s"][1:])
        batch, seq = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1])
                      for f in ("--batch", "--seq"))
        n_params = sum(p.numel() for p in T.flatten(params)[0])
        # params-only checkpoint, written and read back
        ck = Checkpointer(str(tmp / "params"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(params, step=6)
        save_s = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(tmp / "params")
        t0 = time.perf_counter()
        back, _ = ck.restore(api.abstract_params(cfg), device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(
                T.flatten(back)[0], T.flatten(params)[0])):
            raise AssertionError("train: restored params differ")
        emit("train", arch=cfg.name, layers=cfg.n_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
             dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=cfg.remat,
             steps=len(res["losses"]), batch=batch, seq=seq,
             losses=res["losses"], grad_norms=res["grad_norms"],
             step_ms=[s * 1e3 for s in res["step_s"]],
             step_ms_p50_after_first=float(np.percentile(step_s, 50)) * 1e3,
             tokens_per_s=batch * seq / float(np.percentile(step_s, 50)),
             first_step_ms=res["step_s"][0] * 1e3, main_wall_s=wall,
             peak_device_bytes=peak, unchanged_leaves=unchanged,
             ckpt_bytes=ckpt_bytes, ckpt_save_s=save_s,
             ckpt_restore_s=restore_s)
        del res, params, back
        torch.cuda.empty_cache()
        # serve the checkpoint, W4A16
        argv = ["--arch", "qwen2.5-1.5b", "--ckpt", str(tmp / "params"),
                "--quantize", "--method", "best_of_n", "--budget", "8",
                "--tasks", "2", "--continuous", "--paged", "--kv-quant",
                "q8"] + on
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rows = serve.main(argv)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        shapes = ops.gemm_launches_by_shape()
        s = rows[0]["serving"]
        if s["completed_requests"] != 2 or s["completed_samples"] != 16 \
                or not counts["lut_dequant_gemm"] \
                or not counts["quant_paged_attention"]:
            raise AssertionError(f"train/serve-ckpt: {s} {counts}")
        emit("train_serve", path="train/serve-ckpt", args=argv[2:],
             accuracy=rows[0]["accuracy"],
             decode_tok_per_s=s["decode_tok_per_s"], main_wall_s=serve_s,
             launches=counts)
        shutil.rmtree(tmp / "params")
        # the resume chain at 4 layers
        chain = ["--ckpt-dir", str(tmp / "chain"), "--n-layers",
                 str(CHAIN_LAYERS)]
        t0 = time.perf_counter()
        first = train.main(CHAIN_ARGS + chain + ["--steps", "4"] + on)
        second = train.main(CHAIN_ARGS + chain + ["--steps", "6"] + on)
        chain_s = time.perf_counter() - t0
        if first["start"] != 0 or second["start"] != 4 or \
                len(second["losses"]) != 2 or \
                int(second["state"]["step"]) != 6 or not all(
                    map(math.isfinite, first["losses"] + second["losses"])):
            raise AssertionError(f"train/resume: starts {first['start']}, "
                                 f"{second['start']}; losses "
                                 f"{first['losses']} {second['losses']}")
        emit("train_resume", layers=CHAIN_LAYERS, first_start=first["start"],
             second_start=second["start"], losses=first["losses"]
             + second["losses"], ckpt_bytes=_dir_bytes(tmp / "chain"),
             wall_s=chain_s)
        del first, second
        torch.cuda.empty_cache()
        train_4k_run(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"counts": counts, "shapes": shapes, "kv_shapes": {},
            "kv_geom": (cfg.n_kv_heads, cfg.resolved_head_dim())}


# ---------------------------------------------------------------------------
# the distributed layer: ranks that share the one card, over gloo
# ---------------------------------------------------------------------------

# tensor-parallel decode: qwen2.5-1.5b W4A16 at its published width and
# depth, 2 ranks on "model", the dense bf16 cache's 256 slots split over it
DIST_ARCH = "qwen2.5-1.5b"
DIST_ROWS, DIST_PROMPT, DIST_MAX_LEN, DIST_STEPS = 8, 64, 256, 32
# sharded training: launch/train.py under torch.distributed.run, 3 steps of
# 8 x 128, on a 2 x 2 mesh against the same command without --mesh
DIST_MESH = "2x2"
# depth of both training runs: the 2 x 2 run's collectives go through the
# host (gloo), which bounds its step time (PERF.md); widths untouched
DIST_TRAIN_LAYERS = 4
DIST_TRAIN_ARGS = ["--arch", DIST_ARCH, "--steps", "3", "--batch", "8",
                   "--seq", "128", "--log-every", "1"]
TRAIN_RTOL = 2e-3
# olmoe-1b-7b at its published widths, 2 of its 16 layers (two ranks' f32
# inits on one card), forward under a 1 x 2 mesh with tp; the bf16
# tolerance: each output's largest difference over its largest magnitude
DIST_MOE_LAYERS = 2
BF16_TOL = 2e-2
# a token may route differently under the mesh only where the reference's
# k-th and k+1-th router probabilities lie this close
ROUTE_GAP = 1e-2
# compressed_psum of a 64 MB f32 tree over 2 ranks, JAX's bound
DIST_COMP_FLOATS = 16 * 2 ** 20
COMP_RTOL = 2e-2
DIST_TIMEOUT = 420  # seconds per launch of ranks


def _torchrun(nproc: int, args: list, timeout: int = DIST_TIMEOUT) -> str:
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks, its output returned; a non-zero exit or the timeout (the whole
    process group killed) raises."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)] + args
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"dist: {args[:3]} timed out after {timeout} "
                             f"s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"dist: {args[:3]} exited {proc.returncode}:"
                             f"\n{out[-6000:]}")
    return out


def _worker_device():
    import os

    import torch

    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _dist_seqpar(dev) -> dict:
    """Tensor-parallel greedy decode on a (1, 2) mesh: each rank holds its
    ``model`` blocks of the W4A16 weights (q, k, v, gate and up columns,
    o and down rows, the vocab) and its half of the dense bf16 cache's
    sequence (``kv_seq_axis`` "model"); it projects its heads, gathers
    the (B, 1, H, D) activations over ``model``, attends over its cache
    block and merges, sums its row-parallel outputs and samples from its
    vocab block (``models.tensor_parallel``).  Teacher-forced with a
    one-rank decode's tokens (each rank runs that reference on the whole
    cache first): the rank's vocab block of the logits against the
    reference's, and a step's greedy token may differ from the
    reference's only where the reference's top-2 logit gap is under
    ``SPEC_GAP``; K3 launches exactly 168 a step, at the sharded shapes.
    The collectives the rank issues are recorded beside those of the same
    program run as rank 0's on ``meta`` under an ``AbstractMesh`` (the
    dry-run's count)."""
    import dataclasses

    import torch

    from repro_torch import tree as T
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext, shard_of)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.models import transformer as TM
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.train.loop import local_view, shard_params

    cfg = get_config(DIST_ARCH)
    params = cast_params(quantize_model_params(
        TM.init_params(cfg, seed=0, device=dev)), getattr(torch, cfg.dtype))
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(3, cfg.vocab_size, (DIST_ROWS, DIST_PROMPT),
                            generator=gen).to(dev)
    lens = torch.full((DIST_ROWS,), DIST_PROMPT, dtype=torch.int32,
                      device=dev)
    par = ParallelContext(mesh=make_host_mesh(1, 2, device_type="cpu"),
                          kv_seq_axis="model", fsdp=False)
    tp = TP.TPLayout(par)
    with torch.no_grad():
        cache = TM.init_cache(cfg, DIST_ROWS, DIST_MAX_LEN, device=dev)
        first = TM.prefill(params, prompts, cfg, lengths=lens, cache=cache)
        local = {k: shard_of(v, (None, None, "model"), par).clone()
                 for k, v in cache.items()}
        tok, ref_tok, ref_lg = torch.argmax(first, -1), [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DIST_STEPS):
            lg = TM.decode_step(params, tok[:, None].int(), cache, lens + i + 1,
                                cfg)
            ref_tok.append(tok)
            ref_lg.append(lg)
            tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        del cache
        blocks, specs = shard_params(params, par)
        del params
        torch.cuda.empty_cache()
        view = local_view(blocks, specs, par)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with C.record_collectives() as rec:
            tp_lg = [TP.decode_step(view, ref_tok[i][:, None].int(), local,
                                    lens + i + 1, cfg, tp)
                     for i in range(DIST_STEPS)]
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        shapes = ops.gemm_launches_by_shape()
        greedy = SamplerConfig(greedy=True)
        tp_tok = [TP.sample(lg.float(), 0, greedy, cfg, tp) for lg in tp_lg]
        # the same program as rank 0's on meta: the dry-run's count
        apar = dataclasses.replace(
            par, mesh=AbstractMesh((1, 2), ("data", "model")))
        meta = T.map_with_path(lambda _, t: t.to("meta"), blocks)
        mcache = {k: v.to("meta") for k, v in local.items()}
        with C.record_collectives() as mrec:
            for i in range(DIST_STEPS):
                TP.decode_step(local_view(meta, specs, apar),
                               ref_tok[i][:, None].int().to("meta"), mcache,
                               (lens + i + 1).to("meta"), cfg,
                               TP.TPLayout(apar))
    n = tp_lg[0].shape[-1]
    r = tp.r
    max_diff, flips, worst_gap = 0.0, 0, 0.0
    for a, b, t in zip(tp_lg, ref_lg, tp_tok):
        max_diff = max(max_diff, float((a - b[:, r * n:(r + 1) * n]).abs()
                                       .max()))
        top2 = torch.topk(b, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = t.long() != torch.argmax(b, -1)
        if bool(differ.any()):
            flips += int(differ.sum())
            worst_gap = max(worst_gap, float(gap[differ].max()))
    layout = gemm_layout(cfg)
    want = sum(layout.values()) * DIST_STEPS
    # each launch multiplies by the rank's half of its weight
    half = sum(n * K * N for (K, N), n in layout.items()) * DIST_STEPS / 2
    if counts["lut_dequant_gemm"] != want or any(
            n for k, n in counts.items() if k != "lut_dequant_gemm") or \
            any(M != DIST_ROWS for M, _, _ in shapes) or \
            sum(n * K * N for (_, K, N), n in shapes.items()) != half:
        raise AssertionError(f"dist/seqpar: launches {counts} {shapes}, "
                             f"want {want} K3 at the sharded shapes and "
                             f"nothing else")
    if worst_gap > SPEC_GAP:
        raise AssertionError(f"dist/seqpar: a token differs where the "
                             f"reference's top-2 gap is {worst_gap}")
    return {"layers": cfg.n_layers, "rows": DIST_ROWS, "mesh": "1x2",
            "prompt": DIST_PROMPT, "max_len": DIST_MAX_LEN,
            "local_slots": DIST_MAX_LEN // 2, "steps": DIST_STEPS,
            "max_logit_diff": max_diff, "token_flips": flips,
            "worst_flip_gap": worst_gap, "k3_launches": counts[
                "lut_dequant_gemm"], "k3_per_step": counts[
                "lut_dequant_gemm"] / DIST_STEPS, "counts": counts,
            "shapes": [[list(k), n] for k, n in shapes.items()],
            "collectives": rec, "collectives_meta": mrec,
            "step_ms": tp_s / DIST_STEPS * 1e3,
            "ref_step_ms": ref_s / DIST_STEPS * 1e3}


# tensor-parallel prefill and decode of the other families:
# zamba2-1.2b and whisper-base W4A16 at their published widths and depths
# on a 1 x 2 mesh, 8 rows of a 64-token prompt (whisper-base: and 8 clips
# of its 1,500 frames), 16 decode steps.  Each runs with bf16 activations
# (the deployment) and again with f32 activations over the same W4A16
# weights, teacher-forced with the bf16 run's tokens.  In bf16 the logits
# must lie within TP_BF16_RTOL of the one-rank logits' largest magnitude:
# the hybrid's bf16 rule (``reference_ssm_check``); the one-rank bf16
# logits' distance from the one-rank f32 ones is reported beside it (the
# model's own bf16 rounding, which a bf16 flip's gap may reach past
# SPEC_GAP).  In f32 the logits within TP_F32_RTOL of it, and a greedy
# token may differ only where the one-rank top-2 gap is at most SPEC_GAP
DIST_TP_ARCHS = ("zamba2-1.2b", "whisper-base")
DIST_TP_ROWS, DIST_TP_PROMPT, DIST_TP_MAX_LEN, DIST_TP_STEPS = 8, 64, 128, 16
TP_BF16_RTOL = 0.1
TP_F32_RTOL = 1e-4


def tp_gemm_layout(cfg, m: int, part: str = "decoder") -> dict:
    """{(K, N): launches} of K3 per rank in one forward of ``cfg`` on a
    ``model`` axis of ``m`` (``models.tensor_parallel``): a column-parallel
    projection at (K, N / m), a row-parallel one (o, ``out_proj``) at
    (K / m, N), as ``gemm_layout`` lists them (FFN down is Q8, no K3).
    ``part``: Whisper's "decoder" (a decode step, or a prefill's decoder:
    self q, k, v, o, cross q, o and fc1 a layer) or "encoder" (a prefill's
    encoder layers' q, k, v, o, fc1 and every decoder layer's cross k, v
    of the encoder output)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    q, kv = (d, cfg.n_heads * hd // m), (d, cfg.n_kv_heads * hd // m)
    o = (cfg.n_heads * hd // m, d)
    if cfg.family == "encdec":
        fc1 = (d, cfg.d_ff // m)
        blocks = ([([q, kv, kv, o, fc1], cfg.n_encoder_layers),
                   ([kv, kv], cfg.n_layers)] if part == "encoder" else
                  [([q, kv, kv, o, q, o, fc1], cfg.n_layers)])
    else:
        s = cfg.ssm
        di = s.d_inner(d)
        n_in = 2 * di + 2 * s.ngroups * s.d_state + s.n_heads(d)
        apps = cfg.n_layers // cfg.hybrid_attn_every \
            if cfg.hybrid_attn_every else 0
        blocks = [([(d, n_in // m), (di // m, d)], cfg.n_layers),
                  ([q, kv, kv, o, (d, cfg.d_ff // m), (d, cfg.d_ff // m)],
                   apps)]
    out: dict = {}
    for shapes, times in blocks:
        for kn in shapes:
            out[kn] = out.get(kn, 0) + times
    return {kn: n for kn, n in out.items() if n}


def _dist_tp_family(dev, arch: str) -> dict:
    """Tensor-parallel prefill and decode of ``arch`` (zamba2-1.2b or
    whisper-base) W4A16 on a (1, 2) mesh, with bf16 activations and then
    f32 ones over the same weights (``_dist_tp_run``).  Returns the bf16
    run's record with the f32 run's under "f32"."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.quant.qlinear import quantize_model_params

    cfg = get_config(arch)
    qparams = quantize_model_params(api.get_model(cfg).init_params(
        cfg, seed=0, device=dev))
    torch.cuda.empty_cache()
    out, toks, lg = _dist_tp_run(dev, cfg, qparams)
    out["f32"], _, lg32 = _dist_tp_run(dev, cfg.with_(dtype="float32"),
                                       qparams, toks)
    out["one_rank_bf16_vs_f32"] = max(float((a.float() - b).abs().max())
                                      for a, b in zip(lg, lg32))
    return out


def _dist_tp_run(dev, cfg, qparams, forced=None):
    """One run of ``_dist_tp_family`` in ``cfg.dtype``: each rank holds its
    ``model`` blocks of the weights (``in_proj`` columns, ``out_proj``
    rows, the heads' vectors and ``conv`` channels; the attention and MLP
    columns and rows; the vocab where it divides), prefills the 8 rows
    into its part of the cache (``tp_mamba2`` / ``tp_whisper``), then
    takes 16 teacher-forced steps over its cache blocks (zamba2's
    attention cache split along the sequence,
    ``tp_mamba2.decode_cache``).  Each rank first runs the one-rank
    prefill and greedy decode on the whole weights, the reference: the
    rank's vocab block of the logits must lie within TP_BF16_RTOL (bf16)
    or TP_F32_RTOL (f32) of the reference's largest magnitude, and in f32
    a greedy token may differ only where the reference's top-2 gap is at
    most SPEC_GAP.  K3 launches exactly ``tp_gemm_layout`` a forward, at
    the shard shapes; the collectives the rank issues equal the same
    program's run as this rank on ``meta`` under an ``AbstractMesh``.
    ``forced``: the tokens of every step (else the reference's greedy
    ones).  Returns (record, the tokens, the reference's logits)."""
    import dataclasses

    import torch

    from repro_torch import tree as T
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.quant.qlinear import cast_params
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.train.loop import local_view, shard_params

    model = api.get_model(cfg)
    dtype = getattr(torch, cfg.dtype)
    params = cast_params(qparams, dtype)
    gen = torch.Generator().manual_seed(11)
    R, P, ML = DIST_TP_ROWS, DIST_TP_PROMPT, DIST_TP_MAX_LEN
    prompts = torch.randint(3, cfg.vocab_size, (R, P), generator=gen).to(dev)
    lens = torch.full((R,), P, dtype=torch.int32, device=dev)
    kw = {}
    if cfg.family == "encdec":
        kw["embeddings"] = torch.randn(
            (R, cfg.encoder_seq_len, cfg.d_model), generator=gen).to(
                dev, dtype)
    with torch.no_grad():
        cache = model.init_cache(cfg, R, ML, device=dev)
        first = model.prefill(params, prompts, cfg, lengths=lens, cache=cache,
                              **kw)
        tok, ref_tok, ref_lg = torch.argmax(first, -1), [], [first]
        for i in range(DIST_TP_STEPS):
            if forced is not None:
                tok = forced[i]
            lg = model.decode_step(params, tok[:, None].int(), cache,
                                   lens + i + 1, cfg)
            ref_tok.append(tok)
            ref_lg.append(lg)
            tok = torch.argmax(lg, -1)
        del cache
    par = ParallelContext(mesh=make_host_mesh(1, 2, device_type="cpu"),
                          fsdp=False)
    blocks, specs = shard_params(params, par)
    del params
    torch.cuda.empty_cache()
    fam = TP.family(cfg)
    hybrid = cfg.family == "hybrid"

    def program(view, par, inputs, cache, toks, lens):
        """The prefill, then the steps: every call's logits."""
        emb = {"embeddings": kw["embeddings"].to(inputs.device)} if kw \
            else {}
        out = [fam.prefill(view, inputs, cfg, TP.TPLayout(par), lengths=lens,
                           cache=cache, **emb)]
        dpar = dataclasses.replace(par, kv_seq_axis="model") if hybrid \
            else par
        dtp = TP.TPLayout(dpar)
        if hybrid:
            cache = fam.decode_cache(cache, cfg, dtp, ML, P)
        for i, t in enumerate(toks):
            out.append(fam.decode_step(view, t[:, None].int(), cache,
                                       lens + i + 1, cfg, dtp))
        return out

    with torch.no_grad():
        cache = fam.init_cache(cfg, TP.TPLayout(par), R,
                               P if hybrid else ML, device=dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with C.record_collectives() as rec:
            tp_lg = program(local_view(blocks, specs, par), par, prompts,
                            cache, ref_tok, lens)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        shapes = ops.gemm_launches_by_shape()
        greedy = SamplerConfig(greedy=True)
        tp_tok = [TP.sample(lg.float(), 0, greedy, cfg, TP.TPLayout(par))
                  for lg in tp_lg]
        # the same program as this rank's on meta: the dry-run's count
        r = C.axis_index("model", par.mesh)
        apar = dataclasses.replace(par, mesh=AbstractMesh(
            (1, 2), ("data", "model"), coordinate=(0, r)))
        meta = T.map_with_path(lambda _, t: t.to("meta"), blocks)
        mcache = fam.init_cache(cfg, TP.TPLayout(apar), R,
                                P if hybrid else ML, device="meta")
        with C.record_collectives() as mrec:
            program(local_view(meta, specs, apar), apar, prompts.to("meta"),
                    mcache, [t.to("meta") for t in ref_tok], lens.to("meta"))
    V = tp_lg[0].shape[-1]
    max_diff, top, flips, worst_gap = 0.0, 0.0, 0, 0.0
    for a, b, t in zip(tp_lg, ref_lg, tp_tok):
        b = b.float()
        ref = b[:, r * V:(r + 1) * V] if V != cfg.vocab_size else b
        max_diff = max(max_diff, float((a.float() - ref).abs().max()))
        top = max(top, float(b.abs().max()))
        top2 = torch.topk(b, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = t.long() != torch.argmax(b, -1)
        if bool(differ.any()):
            flips += int(differ.sum())
            worst_gap = max(worst_gap, float(gap[differ].max()))
    want: dict = {}
    parts = [(R * P, "decoder")] + ([(R * cfg.encoder_seq_len, "encoder")]
                                    if cfg.family == "encdec" else [])
    for M, part in parts:
        for (K, N), n in tp_gemm_layout(cfg, 2, part).items():
            want[M, K, N] = want.get((M, K, N), 0) + n
    for (K, N), n in tp_gemm_layout(cfg, 2).items():
        want[R, K, N] = want.get((R, K, N), 0) + n * DIST_TP_STEPS
    name = f"dist/tp_{cfg.name.split('-')[0]} ({cfg.dtype})"
    rtol = TP_F32_RTOL if cfg.dtype == "float32" else TP_BF16_RTOL
    if shapes != want or any(n for k, n in counts.items()
                             if k != "lut_dequant_gemm"):
        raise AssertionError(f"{name}: launches {counts} {shapes}, want "
                             f"{want} and nothing else")
    if max_diff > rtol * top or (cfg.dtype == "float32" and
                                 worst_gap > SPEC_GAP):
        raise AssertionError(f"{name}: logits {max_diff} apart (largest "
                             f"{top}, tolerance {rtol} of it), a token "
                             f"differs where the top-2 gap is {worst_gap}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "rows": R, "mesh": "1x2", "prompt": P, "max_len": ML,
            "steps": DIST_TP_STEPS,
            "frames": cfg.encoder_seq_len if cfg.family == "encdec" else 0,
            "max_logit_diff": max_diff, "largest_logit": top,
            "logit_rtol": rtol, "token_flips": flips,
            "worst_flip_gap": worst_gap,
            "k3_per_step": sum(tp_gemm_layout(cfg, 2).values()),
            "k3_launches": counts["lut_dequant_gemm"], "counts": counts,
            "shapes": [[list(k), n] for k, n in shapes.items()],
            "collectives": rec, "collectives_meta": mrec,
            "wall_s": tp_s}, ref_tok, [t.float() for t in ref_lg]


def _dist_sample(dev) -> dict:
    """``distributed_sample`` over qwen2.5-1.5b's 151,936-wide vocab on a
    (1, 2) mesh: greedy equals ``argmax``, the tie rows included (the
    reference test's rows inside one shard, and the same ties across
    shards); Gumbel tokens are valid ids."""
    import torch

    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.sampler import SamplerConfig, distributed_sample

    V = 151936
    par = ParallelContext(mesh=make_host_mesh(1, 2, device_type="cpu"))
    vps = V // 2
    gen = torch.Generator(device=dev).manual_seed(11)
    logits = torch.randn(10, V, generator=gen, device=dev)
    ties = ([7, 23, 55], [0, 63], [40, 41], [7, vps + 7, V - 1],
            [0, V - 1], [vps + 40, vps + 41])
    for r, cols in enumerate(ties):
        logits[r] = -5.0
        logits[r, cols] = float(r % 3 + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = distributed_sample(logits, 0, SamplerConfig(greedy=True), par)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = torch.argmax(logits, -1).int()
    gum = distributed_sample(logits, 1, SamplerConfig(temperature=1.0), par)
    if not torch.equal(tok, want) or tok[:6].tolist() != [
            7, 0, 40, 7, 0, vps + 40] or not bool(
                ((gum >= 0) & (gum < V)).all()):
        raise AssertionError(f"dist/sample: {tok.tolist()} vs "
                             f"{want.tolist()}; gumbel {gum.tolist()}")
    return {"vocab": V, "rows": 10, "greedy_ms": ms,
            "tie_rows": tok[:6].tolist()}


def _dist_moe(dev) -> dict:
    """olmoe-1b-7b (published widths, 2 layers, f32 masters, bf16
    compute) under a (1, 2) mesh with tp against no mesh.  Layer 0's MoE
    on one input: the same routing, aux equal, y within ``BF16_TOL``.  The
    whole forward: each call's routing recorded on both sides; a token may
    route differently only at a near-tie of the reference's router (its
    k-th and k+1-th probabilities within ``ROUTE_GAP``), and every
    position before a row's first such token (which causal attention
    keeps from it) has logits within ``BF16_TOL``."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as TM

    cfg = get_config(MOE_ARCH).with_(n_layers=DIST_MOE_LAYERS)
    k = cfg.moe.top_k
    params = TM.init_params(cfg, seed=0, device=dev)
    par = ParallelContext(mesh=make_host_mesh(1, 2, device_type="cpu"))
    gen = torch.Generator().manual_seed(5)
    B, S = 2, 64
    tokens = torch.randint(3, cfg.vocab_size, (B, S), generator=gen).to(dev)
    hn = torch.randn(B, S, cfg.d_model, generator=gen).to(
        device=dev, dtype=getattr(torch, cfg.dtype))
    calls: list = []
    orig = moe.route

    def recording(logits, m):
        out = orig(logits, m)
        top = torch.topk(torch.softmax(logits.float(), -1), k + 1).values
        calls.append((torch.sort(out[1], -1).values, top[:, k - 1] - top[:, k]))
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            y0, a0 = moe.moe_ffn(params["layers"][0]["moe"], hn, cfg)
            y1, a1 = moe.moe_ffn(params["layers"][0]["moe"], hn, cfg, par)
            l0, _ = TM.forward(params, tokens, cfg)
            l1, _ = TM.forward(params, tokens, cfg, par=par)
    finally:
        moe.route = orig
    same_route = torch.equal(calls[0][0], calls[1][0])
    ref, got = calls[2:2 + cfg.n_layers], calls[2 + cfg.n_layers:]
    first = [S] * B
    flips, worst_gap = 0, 0.0
    for (ids0, gap), (ids1, _) in zip(ref, got):
        differ = (ids0 != ids1).any(-1)
        flips += int(differ.sum())
        for t in torch.nonzero(differ)[:, 0].tolist():
            first[t // S] = min(first[t // S], t % S)
            worst_gap = max(worst_gap, float(gap[t]))
    scale = float(l0.abs().max())
    kept = max(float((l1[b, :first[b]] - l0[b, :first[b]]).abs().max())
               if first[b] else 0.0 for b in range(B)) / scale
    rel = {"y": float((y1 - y0).abs().max() / y0.abs().max()),
           "logits_before_first_flip": kept,
           "logits_all": float((l1 - l0).abs().max()) / scale}
    aux = abs(float(a1) - float(a0))
    if not same_route or aux > 1e-6 or rel["y"] > BF16_TOL or \
            kept > BF16_TOL or worst_gap > ROUTE_GAP or min(first) == 0:
        raise AssertionError(f"dist/moe: same routing {same_route}, {rel}, "
                             f"aux diff {aux}, flips {flips} (gap "
                             f"{worst_gap}), first flips {first}")
    return {"layers": cfg.n_layers, "experts": cfg.moe.n_experts,
            "expert_d_ff": cfg.moe.expert_d_ff, "tokens": B * S,
            "rel_diff": rel, "aux_diff": aux, "tol": BF16_TOL,
            "route_flips": flips, "worst_flip_gap": worst_gap,
            "positions_compared": sum(first)}


def _dist_compression(dev) -> dict:
    """``compressed_psum`` of a 64 MB f32 tree (each rank its own values)
    over 2 ranks against ``psum``: the largest difference over the
    largest sum within ``COMP_RTOL``; each timed once after a warm-up,
    and each one's bytes per rank from the shapes."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 1, device_type="cpu")
    gen = torch.Generator(device=dev).manual_seed(100 + C.axis_index(
        "data", mesh))
    half = DIST_COMP_FLOATS // 2
    tree = {"a": torch.randn(half, generator=gen, device=dev),
            "b": torch.randn(half // 2048, 2048, generator=gen, device=dev)}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    want, plain_ms = timed(lambda: {k: C.psum(v, "data", mesh)
                                    for k, v in tree.items()})
    got, comp_ms = timed(lambda: compressed_psum(tree, mesh, "data"))
    rel = max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
              for k in tree)
    if rel > COMP_RTOL:
        raise AssertionError(f"dist/compression: relative error {rel}")
    # bytes a rank sends under ring algorithms: an all-reduce; an f32
    # reduce-scatter, an int8 all-gather and n f32 scales
    n, size = 2, DIST_COMP_FLOATS * 4
    return {"floats": DIST_COMP_FLOATS, "rel_err": rel, "tol": COMP_RTOL,
            "plain_ms": plain_ms, "compressed_ms": comp_ms,
            "plain_ring_bytes": 2 * (n - 1) / n * size,
            "compressed_ring_bytes": (n - 1) / n * (size + size / 4)
            + 4 * (n - 1)}


def _dist_elastic(dev, out_dir: str, n_layers: int) -> dict:
    """The 2 x 2 run's checkpoint restored onto a (1, 2) mesh and onto one
    rank, both on the card: every (1, 2) block bit-equal to its part of
    the one-rank state, and the 2 x 2 blocks cut from that state hashing
    to the digests the 2 x 2 ranks printed of their trained state after
    their save (this rank checks the 2 x 2 ranks r with r % 2 == its own
    rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext,
                                                  param_specs, shard_of,
                                                  stack_layers)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.train.loop import state_specs
    from repro_torch.train.optimizer import init_opt_state

    cfg = get_config(DIST_ARCH).with_(n_layers=n_layers)
    abstract = stack_layers(api.abstract_params(cfg))
    template = {"params": abstract, "opt": init_opt_state(abstract),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}
    par = ParallelContext(mesh=make_host_mesh(1, 2, device_type="cpu"))
    ck = Checkpointer(str(Path(out_dir) / "ckpt"))
    t0 = time.perf_counter()
    blocks, step = elastic_restore(ck, template, par, device=dev)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole, one_step = elastic_restore(ck, template, ParallelContext(),
                                      device=dev)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    specs = param_specs(template, par)
    bad, n, nbytes = [], 0, 0
    flat_b, _ = T.flatten(blocks)
    flat_w, _ = T.flatten(whole)
    flat_s = [s for _, s in _spec_leaves(specs)]
    for i, (b, w, s) in enumerate(zip(flat_b, flat_w, flat_s)):
        n += 1
        nbytes += b.numel() * b.element_size()
        if not (b.is_cuda and w.is_cuda and torch.equal(b, shard_of(w, s,
                                                                    par))):
            bad.append(i)
    del blocks
    # the 2 x 2 ranks' blocks: rank r at (r // 2, r % 2) of (data, model)
    digests = json.loads((Path(out_dir) / "digests.json").read_text())
    par22 = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")))
    specs22 = state_specs(param_specs(abstract, par22))
    checked = {}
    for r in range(dist.get_rank(), 4, 2):
        coord = {"data": r // 2, "model": r % 2}
        cut = T.unflatten(T.flatten(whole)[1], [
            shard_of(w, s, par22, coord=coord) for w, (_, s) in zip(
                T.flatten(whole)[0], _spec_leaves(specs22))])
        checked[r] = T.digest(cut) == digests[str(r)]
    if bad or step != 3 or one_step != 3 or not all(checked.values()):
        raise AssertionError(f"dist/elastic: steps {step} {one_step}, "
                             f"leaves {bad} differ, 2 x 2 digests "
                             f"{checked}")
    return {"step": step, "leaves": n, "block_bytes": nbytes,
            "restore_mesh_s": mesh_s, "restore_one_s": one_s,
            "digests_equal": sorted(checked)}


def _spec_leaves(tree, path=()):
    """(path, spec) in the sorted-key order of ``tree.flatten``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def dist_worker(out_dir: str) -> int:
    """One rank of the ``dist`` phase's worker group (2 ranks under
    ``torch.distributed.run``, ``gloo``, both on the one card): writes
    its results to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    rank, _ = init_distributed("gloo")
    dev = _worker_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank}
    for name, fn in (("seqpar", _dist_seqpar), ("sample", _dist_sample),
                     ("moe", _dist_moe),
                     ("compression", _dist_compression)):
        res[name] = fn(dev)
        torch.cuda.empty_cache()
    for arch in DIST_TP_ARCHS:
        res[f"tp_{arch.split('-')[0]}"] = _dist_tp_family(dev, arch)
        torch.cuda.empty_cache()
    with open(Path(out_dir) / "layers.txt") as f:
        n_layers = int(f.read())
    res["elastic"] = _dist_elastic(dev, out_dir, n_layers)
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_phase(dev: str = "cuda", train_layers: int = 0) -> dict:
    """The distributed layer on ranks that share the card over ``gloo``
    (NCCL refuses two ranks on one device; every collective goes through
    the host, so no time here says anything about NVLink or NCCL).

    1. ``launch/train.py`` one rank in this process, then ``--mesh 2x2``
       under ``torch.distributed.run`` (4 ranks, ``--backend gloo``, a
       checkpoint at the end): each step's loss within ``TRAIN_RTOL`` of
       the one rank's, each rank's peak bytes beside the one rank's;
       ``train_layers`` cuts the depth of both (0: the config's);
    2. a worker group of 2 ranks (this script with ``--dist-worker``):
       tensor-parallel decode over a sequence-split cache (each rank's
       collectives against the dry-run's count), ``distributed_sample``,
       the MoE's
       sharded branch, ``compressed_psum`` and the elastic restore of the
       2 x 2 checkpoint, held against the digests its ranks printed of
       their trained state (``_dist_*``).
       The group also runs zamba2-1.2b and whisper-base tensor parallel
       on 1 x 2 (``_dist_tp_family``: prefill and 16 steps against one
       rank, each rank's K3 at the shard shapes and its collectives
       against this rank's program on ``meta``).
    Returns {path: {"counts", "shapes", ...}} of "dist/seqpar",
    "dist/tp_zamba2" and "dist/tp_whisper" (rank 0's; every rank's K3
    count is checked)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train

    layers = ["--n-layers", str(train_layers)] if train_layers else []
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dist_", dir=ROOT / "build"))
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = train.main(DIST_TRAIN_ARGS + layers)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated()
        n_layers = one["cfg"].n_layers
        one_losses = one["losses"]
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = _torchrun(4, ["-m", "repro_torch.launch.train", "--mesh",
                            DIST_MESH, "--backend", "gloo", "--ckpt-dir",
                            str(tmp / "ckpt")] + DIST_TRAIN_ARGS + layers)
        mesh_s = time.perf_counter() - t0
        losses = [float(line.split()[3]) for line in out.splitlines()
                  if line.startswith("step ")]
        # the ranks' lines may interleave on one line of the output
        peaks = {int(r): int(n) for r, n in re.findall(
            r"\[train\] rank (\d+) peak device bytes (\d+)", out)}
        digests = dict(re.findall(
            r"\[train\] rank (\d+) state sha256 ([0-9a-f]{64})", out))
        step_s = re.search(r"'step_s': \[([^\]]*)\]", out)
        step_s = [float(x) for x in step_s.group(1).split(",")] \
            if step_s else []
        save_s = re.search(r"saved in ([\d.]+) s", out)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
        if len(losses) != len(one_losses) or len(peaks) != 4 or \
                len(digests) != 4 or max(rel) > TRAIN_RTOL:
            raise AssertionError(f"dist/train: {losses} vs {one_losses}, "
                                 f"peaks {peaks}:\n{out[-3000:]}")
        (tmp / "layers.txt").write_text(str(n_layers))
        (tmp / "digests.json").write_text(json.dumps(digests))
        t0 = time.perf_counter()
        _torchrun(2, [str(ROOT / "chip_smoke.py"), "--dist-worker",
                      str(tmp)])
        worker_s = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sp = [r["seqpar"] for r in ranks]
    tps = {f"tp_{a.split('-')[0]}": [r[f"tp_{a.split('-')[0]}"]
                                     for r in ranks] for a in DIST_TP_ARCHS}
    for name, xs in [("seqpar", sp)] + list(tps.items()) + [
            (f"{k} (float32)", [x["f32"] for x in v]) for k, v in tps.items()]:
        for r, x in enumerate(xs):
            if x["collectives"] != x["collectives_meta"]:
                raise AssertionError(f"dist/{name}: rank {r} issued "
                                     f"{x['collectives']}, the dry-run "
                                     f"counts {x['collectives_meta']}")
    emit("dist", backend="gloo", ranks_share="cuda:0",
         train={"mesh": DIST_MESH, "layers": n_layers,
                "args": DIST_TRAIN_ARGS, "losses": losses,
                "one_rank_losses": one_losses, "rel_diff": rel,
                "tol": TRAIN_RTOL, "rank_peak_bytes": peaks,
                "one_rank_peak_bytes": one_peak, "mesh_wall_s": mesh_s,
                "mesh_step_s": step_s,
                "mesh_ckpt_save_s": float(save_s.group(1)) if save_s
                else None,
                "one_rank_wall_s": one_s},
         seqpar={k: v for k, v in sp[0].items()
                 if k not in ("counts", "shapes", "collectives",
                              "collectives_meta")},
         seqpar_k3_per_rank=[s["k3_launches"] for s in sp],
         seqpar_collectives_per_rank=[s["collectives"] for s in sp],
         seqpar_collectives_meta=sp[0]["collectives_meta"],
         seqpar_step_ms_per_rank=[s["step_ms"] for s in sp],
         sample=ranks[0]["sample"], moe=ranks[0]["moe"],
         compression=ranks[0]["compression"],
         elastic=[r["elastic"] for r in ranks],
         worker_peak_bytes=[r["peak_device_bytes"] for r in ranks],
         worker_wall_s=worker_s)
    for name, xs in tps.items():
        emit(f"dist_{name}", backend="gloo", ranks_share="cuda:0",
             **{k: v for k, v in xs[0].items()
                if k not in ("counts", "shapes", "collectives",
                             "collectives_meta", "f32")},
             f32={k: v for k, v in xs[0]["f32"].items()
                  if k not in ("counts", "shapes", "collectives_meta")},
             f32_max_logit_diff_per_rank=[x["f32"]["max_logit_diff"]
                                          for x in xs],
             k3_per_rank=[x["k3_launches"] for x in xs],
             shapes_per_rank=[x["shapes"] for x in xs],
             collectives_per_rank=[x["collectives"] for x in xs],
             collectives_meta_per_rank=[x["collectives_meta"] for x in xs],
             max_logit_diff_per_rank=[x["max_logit_diff"] for x in xs],
             wall_s_per_rank=[x["wall_s"] for x in xs])
    return {f"dist/{name}": {"counts": xs[0]["counts"],
                             "shapes": {tuple(k): n for k, n in
                                        xs[0]["shapes"]},
                             "kv_shapes": {}, "kv_geom": (2, 128)}
            for name, xs in [("seqpar", sp)] + list(tps.items())}


# ---------------------------------------------------------------------------
# observability: the request tracer and the kernel profiler on the serve
# ---------------------------------------------------------------------------

# Best-of-8 over 2 tasks x 48 tokens (the serve phase's 4 tasks cut to 2
# to hold the phase near 90 s; width untouched).  Each entry: (name, kv,
# impl, extra serve arguments, tracer, profiler's canary rate or None for
# no profiler).  Q8/exact runs four times in turns, off / on / off / on,
# for the cost of observability within one call, then once with the
# canary off, to split that cost; Q4/LUT with both on, where the canary
# measures the LUT softmax's drift over Q4 KV; q8/prefix with both on
# (cache-hit admission steps); spec/self with the tracer (a round's
# verify against the rest); olmoe-1b-7b on Q8/exact with both on, whose
# canary bounds K1/K2's drift at its full width.
OBSERVE_ARGS = SERVE_ARGS + ["--tasks", "2"]
CANARY_RATE = 0.25
OBSERVE_RUNS = (
    ("q8/exact/off", "q8", "exact", [], False, None),
    ("q8/exact/on", "q8", "exact", [], True, CANARY_RATE),
    ("q8/exact/off", "q8", "exact", [], False, None),
    ("q8/exact/on", "q8", "exact", [], True, CANARY_RATE),
    ("q8/exact/on-no-canary", "q8", "exact", [], True, 0.0),
    ("q4/lut/on", "q4", "lut", [], True, CANARY_RATE),
    ("q8/prefix/on", "q8", "exact", ["--prefix-cache", "--fewshot", "3"],
     True, CANARY_RATE),
    ("spec/self/trace", "q8", "exact", ["--spec-k", "4", "--self-draft"],
     True, None),
    ("moe/q8/on", "q8", "exact", ["--arch", MOE_ARCH], True, CANARY_RATE),
    ("ssm/zamba2/on", "dense", "exact", [], True, CANARY_RATE),
)
SPAN_KEYS = ("admit", "prefill", "plan", "decode", "step", "prm",
             "spec_verify")


def _ms_stats(durs_us: list) -> dict:
    import numpy as np

    if not durs_us:
        return {"n": 0, "total_ms": 0.0, "p50_ms": 0.0}
    return {"n": len(durs_us), "total_ms": sum(durs_us) / 1e3,
            "p50_ms": float(np.percentile(durs_us, 50)) / 1e3}


def trace_stats(trace: dict) -> dict:
    """Per-span-name totals and p50 from a Chrome trace's phase track; the
    admission steps (those whose admit span admitted a request): their
    step spans beside the other steps', and their admit and decode spans
    apart (a canary step's decode span holds the canary); the prefills by
    cache hit."""
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"
             and e["tid"] == 0]
    by_name = {n: _ms_stats([e["dur"] for e in spans if e["name"] == n])
               for n in SPAN_KEYS}
    admitting = {e["args"]["step"] for e in spans if e["name"] == "admit"
                 and e["args"].get("admitted", 0) > 0}

    def of(name, inside):
        return _ms_stats([e["dur"] for e in spans if e["name"] == name
                          and (e["args"]["step"] in admitting) == inside])

    return {
        "spans": by_name,
        "admission_step": of("step", True),
        "admission_admit": of("admit", True),
        "admission_decode": of("decode", True),
        "other_step": of("step", False),
        "prefill_hit": _ms_stats([e["dur"] for e in spans
                                  if e["name"] == "prefill"
                                  and e["args"].get("cached")]),
        "prefill_miss": _ms_stats([e["dur"] for e in spans
                                   if e["name"] == "prefill"
                                   and not e["args"].get("cached")]),
    }


def observe_runs() -> list:
    """Serve through ``launch/serve.py`` with ``--trace`` and ``--profile
    --canary-rate`` (or neither) per ``OBSERVE_RUNS``, the counters
    reset just before each run and read just after, and the launches of
    the canary's exact-path replica (hook muted) recorded apart by
    wrapping ``DecodeEngine._canary_step``.  Each traced run's trace and
    report, written under ``build/observe/``, must pass the port's
    validators; a profiled run's per-op calls must equal the launch
    counters less the canary's (one paged attention per layer and decode
    step on the pool, none on dense rows, the model's Q4 projections
    (``gemm_layout``) per decode step, prefill and verify, 2 K4 per
    partial prefill), the canary (where on: paged runs of a nonzero rate)
    must launch those Q4 projections and no paged attention per sample,
    and a dense run none; a speculative run must record one
    ``spec_verify`` span per round.
    Decode tok/s is the scheduler's (decode tokens over its step walls)
    and the wall's (over the time from the engine's build to the serve's
    end).  Prints one ``observe`` line per run and an ``observe_cost``
    line.  Returns the runs' lines."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.profiling import validate_profile_report
    from repro_torch.serving.telemetry import validate_chrome_trace

    out_dir = ROOT / "build" / "observe"
    out_dir.mkdir(parents=True, exist_ok=True)
    orig_build = serve.build_engine
    orig_canary = DecodeEngine._canary_step
    lines = []
    for i, (name, kv, impl, extra, traced, canary_rate) in enumerate(
            OBSERVE_RUNS):
        profiled = canary_rate is not None
        dense = kv == "dense"
        args = (SSM_ARGS + ["--continuous"] if dense
                else OBSERVE_ARGS + ["--kv-quant", kv]) + extra
        tag = f"{i}_{name.replace('/', '_')}"
        trace_path, report_path = (out_dir / f"{tag}.trace.json",
                                   out_dir / f"{tag}.profile.json")
        if traced:
            args += ["--trace", str(trace_path)]
        if profiled:
            args += ["--profile", str(report_path), "--canary-rate",
                     str(canary_rate)]
        built = {}
        canary = []

        def building(a):
            engine, tok = orig_build(a)
            torch.cuda.synchronize()
            built["t0"] = time.perf_counter()
            built["cfg"] = engine.cfg
            return engine, tok

        def canary_step(self, *a, **kw):
            before = ops.launch_counts()
            try:
                return orig_canary(self, *a, **kw)
            finally:
                after = ops.launch_counts()
                canary.append({k: after[k] - before[k] for k in after})

        prev = L.set_paged_attention_impl(impl)
        serve.build_engine = building
        DecodeEngine._canary_step = canary_step
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            rows = serve.main(args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = ops.launch_counts()
        finally:
            serve.build_engine = orig_build
            DecodeEngine._canary_step = orig_canary
            L.set_paged_attention_impl(prev)
        s = rows[0]["serving"]
        in_canary = {k: sum(c[k] for c in canary) for k in counts}
        attn = "quant_paged_attention"
        cfg = built["cfg"]
        n_layers = cfg.n_layers
        # dense rows run no paged attention (and, the canary's replica
        # being a paged one, no canary)
        attn_layers = 0 if dense else n_layers
        k3_fwd = sum(gemm_layout(cfg).values())
        line = {"path": name, "arch": cfg.name, "kv_quant": kv,
                "impl": impl,
                "tracer": traced, "profiler": profiled,
                "canary_rate": canary_rate,
                "steps": s["steps"], "decode_tokens": s["decode_tokens"],
                "decode_tok_per_s": s["decode_tok_per_s"],
                "decode_tok_per_s_wall": s["decode_tokens"] / (
                    t1 - built["t0"]),
                "step_time_p50_ms": s["step_time_p50"] * 1e3,
                "step_time_p99_ms": s["step_time_p99"] * 1e3,
                "prefill_calls": s["prefill_calls"],
                "launches": counts}
        # every path's kernels: one attention launch per layer and decode
        # step on the target (a self-draft round's snapshot steps
        # included) and none elsewhere; K3 and K4 checked through the
        # profile below
        if traced:
            trace = json.loads(trace_path.read_text())
            bad = validate_chrome_trace(trace)
            if bad:
                raise AssertionError(f"observe {name}: invalid trace: "
                                     f"{bad[:3]}")
            line.update(trace_stats(trace))
            line.update({k: s[k] * 1e3 for k in (
                "ttft_p50", "ttft_p99", "itl_p50", "itl_p99",
                "queue_wait_p50", "queue_wait_p99")})
            line["latency_requests"] = s["latency_requests"]
            if line["latency_requests"] != 2:
                raise AssertionError(f"observe {name}: "
                                     f"{line['latency_requests']} latency "
                                     f"records for 2 requests")
        if s["spec_rounds"]:
            dec = line["spans"]["decode"]["total_ms"]
            ver = line["spans"]["spec_verify"]
            line.update(spec_rounds=s["spec_rounds"],
                        verify_share_of_rounds=ver["total_ms"] / dec,
                        accepted_tokens_per_step=s[
                            "accepted_tokens_per_step"])
            if ver["n"] != s["spec_rounds"] or \
                    counts["lut_dequant_kv"] != 2 * s["spec_rounds"]:
                raise AssertionError(
                    f"observe {name}: {ver['n']} spec_verify spans, "
                    f"{counts['lut_dequant_kv']} K4 launches for "
                    f"{s['spec_rounds']} rounds")
        if profiled:
            rep = json.loads(report_path.read_text())
            bad = validate_profile_report(rep)
            if bad:
                raise AssertionError(f"observe {name}: invalid report: "
                                     f"{bad[:3]}")
            k, ph = rep["kernels"], rep["phases"]
            fwd = sum(ph.get(p, {}).get("calls", 0)
                      for p in ("decode", "prefill", "spec_verify"))
            want = {
                "paged_flash_decode": (counts[attn] - in_canary[attn],
                                       attn_layers * ph["decode"]["calls"]),
                "lut_dequant_matmul": (
                    counts["lut_dequant_gemm"]
                    - in_canary["lut_dequant_gemm"], k3_fwd * fwd),
                "lut_dequant_kv": (counts["lut_dequant_kv"]
                                   - in_canary["lut_dequant_kv"],
                                   counts["lut_dequant_kv"]),
            }
            for op, (launched, per_phase) in want.items():
                calls = k.get(op, {}).get("calls", 0)
                if not calls == launched == per_phase:
                    raise AssertionError(
                        f"observe {name}: {op} {calls} hooked calls, "
                        f"{launched} launches outside the canary, "
                        f"{per_phase} by phase")
            n_can = s["canary_samples"]
            canary_on = canary_rate != 0 and not dense
            if n_can != len(canary) or (n_can >= 1) != canary_on or \
                    in_canary[attn] != 0 or \
                    in_canary["lut_dequant_gemm"] != k3_fwd * n_can:
                raise AssertionError(f"observe {name}: canary {n_can} "
                                     f"samples, launches {in_canary}")
            line.update(
                kernel_time_share=s["kernel_time_share"],
                roofline_efficiency_p50=s["roofline_efficiency_p50"],
                ops={op: {"calls": v["calls"],
                          "bound_ms": v["bound_s"] * 1e3,
                          "wall_ms": v["wall_s"] * 1e3,
                          "efficiency": v["efficiency"]}
                     for op, v in k.items()},
                phases={p: {"calls": v["calls"], "wall_ms": v["wall_s"] * 1e3,
                            "bound_ms": v["bound_s"] * 1e3,
                            "efficiency_p50": v["efficiency_p50"]}
                        for p, v in ph.items()},
                canary={"samples": n_can, "rows": rep["canary"]["rows"],
                        "max_logit_err": s["canary_max_logit_err"],
                        "argmax_flip_rate": s["canary_argmax_flip_rate"],
                        "kv_roundtrip_err": s["canary_kv_roundtrip_err"],
                        "warnings": rep["canary"]["warnings"]},
                canary_launches=in_canary)
        elif counts[attn] != n_layers * s["steps"] and not s["spec_rounds"]:
            raise AssertionError(f"observe {name}: {counts[attn]} attention "
                                 f"launches for {s['steps']} steps")
        emit("observe", **line)
        lines.append(line)
    flags = ("off", "on", "on-no-canary")
    q8 = {flag: [ln for ln in lines if ln["path"] == f"q8/exact/{flag}"]
          for flag in flags}
    emit("observe_cost", order=[ln["path"] for ln in lines[:5]], **{
        f"{key}_{flag}": [ln[key] for ln in q8[flag]]
        for key in ("decode_tok_per_s", "decode_tok_per_s_wall",
                    "step_time_p50_ms") for flag in flags})
    return lines


def profile_decode(base_args: list = SERVE_ARGS,
                   kv: tuple = ("--kv-quant", "q8")) -> None:
    """Where a decode step's time goes at full width: one Best-of-8 task
    of ``base_args``'s model (Q8 KV and exact softmax on the pool, or
    ``kv=()`` on dense rows without ``--paged``) served under
    ``torch.profiler``; device busy share = summed kernel time over the
    serve's wall time.  For an MoE model, the experts' share: each
    layer's expert dequant (``moe.expert_weights``: Q4 gate/up and Q8
    down to f32, then bf16) and expert products
    (``moe.dispatch_compute_combine`` at the step's 8 rows), timed with
    CUDA events on layer 0's weights, times the layers, over the step's
    device and wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import reward as R
    from repro_torch.core.controller import TTSSpec, sweep
    from repro_torch.data import tasks as T
    from repro_torch.launch import serve

    args = serve.parse_args(base_args + list(kv) + ["--tasks", "1",
                                                    "--max-tokens", "16"])
    engine, tok = serve.build_engine(args)
    tasks = T.gen_dataset(123, 1)
    spec = TTSSpec("best_of_n", args.budget, args.max_tokens)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sweep(engine, tok, tasks, [spec], gen, R.OracleVerifier(),
          continuous=True)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows = sweep(engine, tok, tasks, [spec], gen, R.OracleVerifier(),
                     continuous=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = rows[0]["serving"]["steps"]
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    cpu_ops = sum(e.count for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::"))

    def by_kernel(*names):
        """(device ms per step, launches) of the kernels named ``names``:
        the run's one prefill included, as in the serve's step counts."""
        ev = [e for e in kernels if any(n in e.key for n in names)]
        return (sum(e.self_device_time_total for e in ev) / 1e3 / steps,
                sum(e.count for e in ev))

    k3_ms, k3_n = by_kernel("tc_gemm_kernel", "tile_gemm_kernel",
                            "fma_gemm_kernel")
    k2_ms, k2_n = by_kernel("paged_attention_kernel", "fold_kernel")
    cfg = engine.cfg
    extra = {}
    if cfg.moe:
        extra = moe_step_costs(engine, device_ms / steps,
                               wall * 1e3 / steps)
    emit("profile", arch=cfg.name,
         kv="paged" if engine.paged else "dense", kv_quant=args.kv_quant,
         impl="exact", steps=steps,
         k3_device_ms_per_step=k3_ms, k3_kernel_launches=k3_n,
         k2_device_ms_per_step=k2_ms, k2_kernel_launches=k2_n,
         wall_ms_per_step=wall * 1e3 / steps,
         device_ms_per_step=device_ms / steps,
         device_busy_share=device_ms / (wall * 1e3),
         aten_ops_per_step=cpu_ops / steps,
         top_kernels=[{"name": e.key[:80], "count": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in top], **extra)


def moe_step_costs(engine, device_ms: float, wall_ms: float) -> dict:
    """An MoE decode step's expert work at 8 rows, timed with CUDA events
    on layer 0's experts: the dequant of all experts (the bytes it must
    move: codes, scales and codebooks in, bf16 stacks out) and the routed
    products over the (E, C, d) buffer; per step, times the layers, and as
    shares of the step's device and wall ms."""
    import torch

    from repro_torch.models import moe as MO

    cfg, p = engine.cfg, engine.params["layers"][0]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    logits = torch.matmul(x, p["router"]["w"].to(x.dtype))
    weights, ids, _ = MO.route(logits, cfg.moe)
    ex = MO.expert_weights(p["experts"], torch.bfloat16)
    deq_ms = time_ms(lambda: MO.expert_weights(p["experts"], torch.bfloat16),
                     iters=10)
    prod_ms = time_ms(lambda: MO.dispatch_compute_combine(
        x, weights, ids, ex, cfg.moe), iters=20)
    del ex
    nbytes = sum(t.numel() * t.element_size() for leaf in p["experts"].values()
                 for t in leaf.values())
    nbytes += sum(2 * leaf["codes"].shape[0] * leaf["codes"].shape[1]
                  * leaf["codes"].shape[2] * (2 if "codebook" in leaf else 1)
                  for leaf in p["experts"].values())   # bf16 stacks out
    L = cfg.n_layers
    b_ms, _ = bound(nbytes, 0, "bfloat16")
    return {"expert_dequant_ms_per_layer": deq_ms,
            "expert_dequant_bytes_per_layer": nbytes,
            "expert_dequant_bound_ms_per_layer": b_ms,
            "expert_products_ms_per_layer": prod_ms,
            "expert_dequant_ms_per_step": deq_ms * L,
            "expert_products_ms_per_step": prod_ms * L,
            "expert_dequant_share_of_device": deq_ms * L / device_ms,
            "expert_products_share_of_device": prod_ms * L / device_ms,
            "expert_dequant_share_of_wall": deq_ms * L / wall_ms,
            "expert_products_share_of_wall": prod_ms * L / wall_ms}


# ---------------------------------------------------------------------------
# the dry-run: one production-mesh cell on meta, and a cell held to the card
# ---------------------------------------------------------------------------

# (a) the one-cell dry-run of the JAX package's system test, through the
# port's CLI, on the CPU of this machine (the card hidden from it)
DRYRUN_CLI = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--multi-pod"]
# (b) a mesh-less registry cell that one card holds whole and that launches
# K3: whisper-base W4A16 decoding 128 rows against 32768 cached positions
# (self K/V 48 GiB, cross K/V 2.2 GiB); 42 Q4 projections a step
DRYRUN_CELL = ("whisper-base", "decode_32k")
# the card's peak over its arguments against the dry-run's temp bytes,
# both as the bytes requested of the caching allocator: within this share
# of them plus DRYRUN_SLACK (cuBLAS workspace, device temporaries of aten
# ops that meta does not allocate)
DRYRUN_TEMP_RTOL = 0.02
DRYRUN_SLACK = 64 << 20


def _requested(key: str = "current") -> int:
    """Bytes requested of the CUDA caching allocator (before its block
    rounding: 512 B, and up to the unsplit rest of a segment for large
    blocks), now or at the peak since the last reset."""
    import torch

    return torch.cuda.memory_stats()[f"requested_bytes.all.{key}"]


def _materialize(tree, cfg, dev, cache_len_max: int):
    """Tensors on ``dev`` for a cell's ``meta`` arguments: fp leaves
    N(0, 0.02) in place (no f32 copy of a bf16 leaf), Q8/Q4 codes random,
    f16 scales in [0.005, 0.015), the q4 codebook itself, int32 tokens
    below the vocab and lengths in [1, ``cache_len_max``]."""
    import torch

    from repro_torch.quant.codebooks import get_codebook

    def one(name, t):
        if not isinstance(t, torch.Tensor):
            return t
        if name == "codebook":
            return get_codebook("q4_0").to(dev).expand(t.shape).contiguous()
        if t.dtype == torch.float16:
            return torch.empty(t.shape, dtype=t.dtype,
                               device=dev).uniform_(0.005, 0.015)
        if t.dtype.is_floating_point:
            return torch.empty(t.shape, dtype=t.dtype,
                               device=dev).normal_(0.0, 0.02)
        if t.dtype == torch.uint8:
            return torch.randint(0, 256, t.shape, dtype=t.dtype, device=dev)
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, dtype=t.dtype,
                                 device=dev)
        if name == "cache_len":
            return torch.randint(1, cache_len_max + 1, t.shape,
                                 dtype=t.dtype, device=dev)
        return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                             device=dev)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return one(name, node)

    return walk(tree, "")


def dryrun_phase(dev: str = "cuda") -> dict:
    """(a) ``python -m repro_torch.launch.dryrun`` on DRYRUN_CLI's cell
    (512 devices, on meta, CUDA_VISIBLE_DEVICES empty): its record on a
    ``dryrun`` line, with 512 devices and FLOPs > 0.  (b) ``run_cell`` of
    DRYRUN_CELL with no mesh and W4A16 weights, then the same cell's
    arguments built on the card and its step run once: the bytes the
    arguments request of the allocator equal ``argument_bytes`` (what it
    allocates, its blocks rounded, stands beside them), the peak request
    over them lies within DRYRUN_TEMP_RTOL x ``temp_bytes`` +
    DRYRUN_SLACK of ``temp_bytes``,
    the K3 launches equal the dry-run's hooked K3 calls and the hooked
    FLOPs on the card its kernel FLOPs; a ``dryrun_check`` line."""
    import gc
    import os

    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.configs.inputs import build_cell
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CLI,
         "--out", str(out_dir)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rec = json.loads((out_dir / "mamba2-130m__decode_32k__2x16x16.json")
                     .read_text())
    if rec["n_devices"] != 512 or not rec["per_device"]["flops"] > 0:
        raise AssertionError(f"dryrun CLI record: {rec}")
    emit("dryrun", cli_s=time.perf_counter() - t0, record=rec)

    arch, shape = DRYRUN_CELL
    cfg = get_config(arch)
    hooked: dict = {}
    pred = dryrun.run_cell(arch, shape, ParallelContext(),
                           out_dir=str(out_dir), mesh_tag="1",
                           quantized=True, kernels=hooked)
    pd = pred["per_device"]
    cell = build_cell(arch, SHAPES_BY_NAME[shape], ParallelContext(),
                      quantized=True)
    n_args = sum(1 for t in T.flatten(list(cell.args))[0]
                 if isinstance(t, torch.Tensor))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_req = torch.cuda.memory_allocated(), _requested()
    params, cache, tokens, cache_len, seed = cell.args
    args = (_materialize(params, cfg, dev, 0),
            _materialize(cache, cfg, dev, 0),
            _materialize({"tokens": tokens}, cfg, dev, 0)["tokens"],
            _materialize({"cache_len": cache_len}, cfg, dev,
                         SHAPES_BY_NAME[shape].seq_len)["cache_len"], seed)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    arg_req = _requested() - base_req
    if arg_req != pd["argument_bytes"]:
        raise AssertionError(f"dryrun_check: arguments request {arg_req} "
                             f"bytes on the card ({arg_bytes} allocated), "
                             f"{pd['argument_bytes']} predicted ({n_args} "
                             f"tensors)")
    card_hooked: dict = {}

    def hook(name, flops, nbytes):
        d = card_hooked.setdefault(name, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
        d["calls"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    prev = ops.set_op_hook(hook)
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            tok, _ = cell.fn(*args)
        torch.cuda.synchronize()
    finally:
        ops.set_op_hook(prev)
    step_s = time.perf_counter() - t0
    peak = _requested("peak") - base_req - arg_req
    peak_alloc = torch.cuda.max_memory_allocated() - base - arg_bytes
    k3 = G.lut_dequant_gemm.launches
    want_k3 = hooked["lut_dequant_matmul"]["calls"]
    ok_tok = tuple(tok.shape) == (SHAPES_BY_NAME[shape].global_batch,) and \
        bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    gap = peak - pd["temp_bytes"]
    row = dict(cell=f"{arch}:{shape}", quantized=True, tensors=n_args,
               argument_bytes=pd["argument_bytes"],
               card_argument_bytes=arg_req,
               card_argument_bytes_allocated=arg_bytes,
               temp_bytes=pd["temp_bytes"], card_peak_over_arguments=peak,
               card_peak_over_arguments_allocated=peak_alloc,
               temp_gap_bytes=gap, temp_rtol=DRYRUN_TEMP_RTOL,
               temp_slack_bytes=DRYRUN_SLACK, output_bytes=pd["output_bytes"],
               alias_bytes=pd["alias_bytes"], flops=pd["flops"],
               bytes_accessed=pd["bytes_accessed"], k3_launches=k3,
               k3_hooked_calls=want_k3,
               kernel_flops=hooked["lut_dequant_matmul"]["flops"],
               card_hooked_flops=card_hooked.get(
                   "lut_dequant_matmul", {}).get("flops", 0.0),
               step_s=step_s, tokens_ok=ok_tok,
               launches=ops.launch_counts())
    emit("dryrun_check", **row)
    del args, tok, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    if k3 != want_k3 or k3 != sum(gemm_layout(cfg).values()) or \
            row["card_hooked_flops"] != row["kernel_flops"] or not ok_tok or \
            abs(gap) > DRYRUN_TEMP_RTOL * pd["temp_bytes"] + DRYRUN_SLACK:
        raise AssertionError(f"dryrun_check failed: {row}")
    return row


def kernel_rows(results: list, runs: dict, phases: dict) -> list:
    """The rows of the kernels line.  Each row's launches come from the
    serve run of its own path; K3 runs on every path: its rows carry the
    count of the first path that launched the row's (M, K, N), and every
    path's count beside it; K4 rows carry their path's count at the row's
    (mode, R); K5 and K6 rows their phase's count at the row's shape.  A
    row whose kernel its path or phase never launched fails.  K1/K2 rows,
    like K3's, carry every path's count beside their own."""
    kernels = []
    for row in results:
        row = dict(row)
        key = row.pop("counter")
        if isinstance(key, tuple) and key[0] == "by_shape":
            row["launches"] = phases[row["path"]]["by_shape"].get(key[1], 0)
        elif isinstance(key, tuple) and key[0] == "kv":
            row["launches"] = runs[row["path"]]["kv_shapes"].get(key[1:], 0)
        elif isinstance(key, tuple):
            row["launches"] = runs[row["path"]]["shapes"].get(key, 0)
            row["launches_by_path"] = {p: r["shapes"].get(key, 0)
                                       for p, r in runs.items()}
        else:
            row["launches"] = runs[row["path"]]["counts"][key]
            row["launches_by_path"] = {p: r["counts"][key]
                                       for p, r in runs.items()}
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: not launched on its path")
        kernels.append(row)
    return kernels


def pin_autotune_cache() -> str:
    """Point ``REPRO_AUTOTUNE_CACHE`` at a fresh empty cache file in a
    temporary directory under ``build/`` (the wrappers then launch their
    analytic choices, whatever ``runs/autotune.json`` the machine holds);
    returns the directory."""
    import os
    import tempfile

    from repro_torch.kernels import autotune as AT

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="autotune-pinned-", dir=ROOT / "build")
    path = os.path.join(tmp, "autotune.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": {}}, f)
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    os.environ.pop("REPRO_AUTOTUNE", None)
    AT.reset()
    return tmp


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    pinned = pin_autotune_cache()
    try:
        return _main()
    finally:
        shutil.rmtree(pinned, ignore_errors=True)


def _main() -> int:
    import torch

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

    dryrun_phase()
    results: list = []
    check_paged_kernels(results)
    reference_check()
    reference_family_check()
    reference_ssm_check()
    reference_whisper_check()
    reference_train_check()
    runs, spec = serve_runs()
    spec_parity(spec, spec.pop("eos_id"))
    runs["long"] = long_phase()
    runs["encdec/whisper"] = whisper_run()
    runs["train/serve-ckpt"] = train_phase()
    runs.update(dist_phase(train_layers=DIST_TRAIN_LAYERS))
    observe_runs()
    # K3 and K4 at the shapes the serve runs launched them with: K3's M on
    # the north-star path (8 decode slots, a Best-of-N group's padded
    # prompt), on the prefix paths (each prefill's batch x its longest
    # suffix), on the TTS paths (the direct path's 64-token prompt width),
    # on the speculative paths (the verify's 8 slots x W), on the
    # olmoe-1b-7b paths (its (2048, 2048) projections) and on the dense
    # paths (zamba2-1.2b's in_proj (2048, 8384), out_proj (4096, 2048)
    # and shared block; qwen2.5-1.5b's over 2 tasks) and on whisper-base
    # (M = 3000 in its encoder and cross K/V, 8 in its decoder); K4's R
    # on the prefix paths and the verify's prefix gathers
    gemm_mkn, kv_r = {}, {}
    for path in ("q8/exact", "q8/prefix", "q4/prefix", "sc/direct",
                 "beam/sched", "beam/direct") + SPEC_PATHS + MOE_PATHS + \
            ("q4/stablelm",) + DENSE_PATHS + (
                "encdec/whisper", "long", "dist/seqpar", "dist/tp_zamba2",
                "dist/tp_whisper"):
        for mkn in runs[path]["shapes"]:
            gemm_mkn.setdefault(mkn, path)
        for mode, r in runs[path]["kv_shapes"]:
            kv_r.setdefault((mode, r, *runs[path]["kv_geom"]), path)
    check_gemm_kernel(results, gemm_mkn)
    check_long_paged(results)
    check_dequant_kv_kernel(results, kv_r)
    phases = {"flash": flash_phase(results),
              "quantize": quantize_phase(results)}
    autotune_phase()
    profile_decode()
    profile_decode(MOE_ARGS)
    profile_decode(SSM_ARGS, kv=())

    kernels = kernel_rows(results, runs, phases)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main())
