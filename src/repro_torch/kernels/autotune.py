"""Launch choices, analytic costs and the roofline bound of the kernel
wrappers.

The port of the JAX package's ``kernels/autotune``, in two halves.

**Costs.**  :func:`pick_block` (the divisibility contract every block
choice goes through), one cost model per kernel, each returning
``(flops, hbm_bytes)`` for one call, and :func:`roofline_bound_s`.
``serving/profiling.KernelProfiler`` divides measured wall time into
these bounds and ``chip_smoke.py`` prints them beside each kernel's time,
so the two can never disagree about what a kernel should cost.  FLOPs are
the JAX package's.  Bytes are what the port's kernels move: bf16
activations in and out, packed 4-bit codes, f16 scales, the 16-entry
codebook, and the pool's storage bytes per token slab; the JAX package
counts its TPU kernels' f32 operands instead.

**Choices.**  Each wrapper with a launch parameter asks this module for
it, per shape:

- K3 ``lut_dequant_gemm``: the split of K, :func:`gemm_plan` (a
  ``lut_dequant_gemm.Plan``);
- K5 ``lut_softmax_attention`` through ``ops.flash_attention``: the KV
  block, :func:`attn_blocks`;
- K6 ``tile_quantize``: the load width, :func:`quantize_wide`.

Lookup order per shape, as in the JAX package: the in-process memo, then
a measured entry in the cache file (``runs/autotune.json``, or
``REPRO_AUTOTUNE_CACHE``), then the analytic choice.  The analytic choice
is the wrapper's own planner (``lut_dequant_gemm.plan``, :func:`pick_block`,
``tile_quantize.wide_loads``), so with no measured entry every launch is
the planner's, bit for bit.  ``REPRO_AUTOTUNE=0`` ignores the cache.
The environment is read at import and by :func:`reset`, not per call:
after changing it, call :func:`reset`.  The memo is keyed on the shape's
integers, so a served call costs one dict lookup.

A measured entry comes from :func:`tune_gemm`, :func:`tune_attn` or
:func:`tune_quantize` (the counterpart of the JAX package's
``benchmarks/kernel_ablation.autotune_gemm``), which time every candidate
on the card with CUDA events and :func:`record` the fastest, or from
``scripts/sweep_gemm.py --record``.  A winner is a property of the card:
the port's keys start with ``cuda:`` and the card's name, which no JAX
key can (those start with the kernel's name), so both packages share one
file, each reading only its own entries and :func:`record` keeping every
entry it does not write.  An entry under a port key that is not one of
that shape's candidates raises ``ValueError``.

K5's output depends on its KV block (the fp16 running max is rounded once
per block), so a measured ``bkv`` changes K5's numerics exactly as a
measured entry of the JAX package changes its kernel's.  A K3 split of K
sums K in another order: its f32 sums may differ in the last bits.

What has no counterpart here:

- the roofline-scored choice among Pallas grids (``_roofline_score``'s
  VMEM budget and per-grid-step cost): it ranks block shapes on the
  TPU; the port's planners already encode sweeps on the card;
- ``dequant_key`` / ``dequant_rows`` (K4): the port's K4 launch has no
  row-block parameter (``csrc/lut_dequant_kv.cu``);
- K1/K2's split count stays with ``paged_attention.splits``: the JAX
  package has no paged-attention scorer, so tuning it would be a feature
  the reference lacks.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import time
from typing import Callable, Mapping, Sequence

# NVIDIA H100 80GB HBM3, 700.00 W (SXM), published dense peaks: HBM
# bytes/s and FLOP/s by operand type (the served kernels run bf16)
HBM_BW = 3.35e12
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]


def pick_block(n: int, target: int, multiple_of: int = 1) -> int:
    """Largest divisor of ``n`` that is <= ``target`` and a multiple of
    ``multiple_of``; falls back to ``n`` itself when no smaller divisor
    qualifies.

    Raises ``ValueError`` when no valid block exists at all, i.e. ``n``
    itself violates ``multiple_of``.
    """
    b = min(n, target)
    while b > 1 and (n % b or b % multiple_of):
        b -= 1
    if b > 1:
        return b
    if n % multiple_of:
        raise ValueError(
            f"no valid block size for an axis of size {n}: blocks must "
            f"divide {n} and be a multiple of {multiple_of} (target "
            f"{target}), but {n} itself is not a multiple of {multiple_of}")
    return n


def block_candidates(n: int, target: int, multiple_of: int = 1,
                     max_candidates: int = 4) -> list[int]:
    """Valid block sizes (divisors of ``n``, multiples of ``multiple_of``),
    largest first from ``min(n, target)``, at most ``max_candidates``;
    ``[pick_block(...)]`` (``n`` itself, or a raise) when there is none."""
    out = []
    b = min(n, target)
    while b >= 1 and len(out) < max_candidates:
        if n % b == 0 and b % multiple_of == 0:
            out.append(b)
        b -= 1
    return out or [pick_block(n, target, multiple_of)]


def roofline_bound_s(flops: float, hbm_bytes: float) -> float:
    """Analytic lower bound on wall seconds: compute- or bandwidth-bound,
    whichever is worse.  The profiler divides it by measured wall time
    to get achieved-vs-peak efficiency."""
    return max(flops / PEAK_FLOPS, hbm_bytes / HBM_BW)


def gemm_cost(M: int, K: int, N: int, *, x_bytes: int = 2,
              scale_bytes: int | None = None) -> tuple[float, float]:
    """LUT-dequant GEMM (K3): x (M, K) @ 4-bit codes (K, N / 2 bytes) ->
    (M, N) in x's dtype (``x_bytes`` each), reading the f16 scales
    (default: the tile scheme's (K / 2, N / 16)) and the 64-byte
    codebook once."""
    if scale_bytes is None:
        scale_bytes = (K // 2) * (N // 16) * 2
    hbm = M * K * x_bytes + K * N // 2 + scale_bytes + 64 + M * N * x_bytes
    return 2.0 * M * N * K, float(hbm)


def attn_cost(BH: int, Sq: int, Skv: int, D: int, *,
              bq: int | None = None) -> tuple[float, float]:
    """LUT-softmax flash attention over (BH, Sq|Skv, D) fp16 operands:
    (flops, bytes), with k and v read once per q block when ``bq`` is
    given."""
    q_rep = 1 if bq is None else Sq // bq
    hbm = BH * (Sq * D * 2 + 2 * Skv * D * 2 * q_rep + Sq * D * 2)
    return 4.0 * BH * Sq * Skv * D, float(hbm)


def paged_attn_cost(B: int, Hq: int, W: int, bs: int, D: int, *,
                    slab_bytes: float, q_bytes: int = 2,
                    tokens: int | None = None) -> tuple[float, float]:
    """Paged decode attention (K1/K2): q (B, 1, Hq, D) against each row's
    table of W blocks of ``bs`` tokens.  ``slab_bytes`` is one token's
    (Hkv, D) slab in pool storage (codes + scales on a quantized pool), so
    a Q8 pool moves about half a bf16 pool's KV bytes.  ``tokens`` is the
    KV tokens attended over all rows; None counts every table slot
    (B W bs, the JAX package's count, which needs no read of the lengths).
    q is read and the output written in q's dtype (``q_bytes``), the
    table and lengths as int32."""
    if tokens is None:
        tokens = B * W * bs
    hbm = (2 * B * Hq * D * q_bytes + 2 * tokens * slab_bytes
           + B * W * 4 + B * 4)
    return 4.0 * Hq * D * tokens, float(hbm)


def dequant_kv_cost(R: int, H: int, D: int, mode: str, *, gr: int = 2,
                    gc: int = 16) -> tuple[float, float]:
    """KV-slab dequant (K4): R token slabs of (H, D) Q8 codes (or packed
    Q4) and (H / gr, D / gc) f16 scales -> f32, plus the codebook."""
    codes = R * H * (D // 2 if mode == "q4" else D)
    scales = R * (H // gr) * (D // gc) * 2
    return 2.0 * R * H * D, float(codes + scales + 64 + R * H * D * 4)


def quantize_cost(K: int, N: int, *,
                  scale_bytes: int = 0) -> tuple[float, float]:
    """Tile quantization (K6) of a (K, N) f32 weight to 4-bit codes:
    (flops, bytes).  ``scale_bytes``: the scales written beside the codes
    (K N / 16 for K6's f16 tile scales; 0 is the JAX package's count)."""
    return 4.0 * K * N, float(K * N * 4 + K * N // 2 + scale_bytes)


# ---------------------------------------------------------------------------
# Settings, the cache file and the choice
# ---------------------------------------------------------------------------

_MEMO: dict = {}                 # (kernel, shape ints...) -> launch choice
_FILE_CACHE: dict | None = None  # the cache file's entries, once read
_CARD: str | None = None
_ENABLED = True


def enabled() -> bool:
    """Whether measured entries are consulted (``REPRO_AUTOTUNE`` is not
    "0"); the choices read it at import and at :func:`reset`."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def cache_path() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE", "runs/autotune.json")


def reset() -> None:
    """Drop the memo and the loaded cache file, and read the environment
    again."""
    global _FILE_CACHE, _CARD, _ENABLED
    _MEMO.clear()
    _FILE_CACHE = None
    _CARD = None
    _ENABLED = enabled()


def card() -> str:
    """The name of the current CUDA device (``"cpu"`` without one): part
    of every port key, since a measured winner is the card's."""
    global _CARD
    if _CARD is None:
        import torch

        _CARD = (torch.cuda.get_device_name(torch.cuda.current_device())
                 if torch.cuda.is_available() else "cpu")
    return _CARD


def _read_entries(path: str) -> dict:
    try:
        with open(path) as f:
            entries = json.load(f).get("entries", {})
    except (OSError, ValueError, AttributeError):
        return {}
    return entries if isinstance(entries, dict) else {}


def _load_cache() -> dict:
    global _FILE_CACHE
    if _FILE_CACHE is None:
        _FILE_CACHE = _read_entries(cache_path())
    return _FILE_CACHE


def record(key: str, blocks: Sequence[int], us: float) -> None:
    """Record a measured choice for ``key`` in the cache file, in the JAX
    package's format ({"version": 1, "entries": {key: {"blocks", "us",
    "source"}}}).  The file is read again first, so every entry this call
    does not write stays, the JAX package's included; it is replaced
    whole (a temporary file renamed over it).  Drops the memo."""
    global _FILE_CACHE
    path = cache_path()
    entries = _read_entries(path)
    entries[key] = {"blocks": [int(b) for b in blocks], "us": float(us),
                    "source": "measured"}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", prefix=".autotune-")
    with os.fdopen(fd, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _FILE_CACHE = entries
    _MEMO.clear()


def choose(key: str, candidates: Mapping[tuple, object], analytic):
    """The launch for ``key``: the measured entry's ``blocks`` looked up
    in ``candidates`` ({blocks as recorded: launch}), else ``analytic``
    (always, with autotuning off).  Raises ``ValueError`` naming the file
    and the key when the entry is not a candidate.  The kernels'
    functions below look up their memo before they call it."""
    if not _ENABLED:
        return analytic
    ent = _load_cache().get(key)
    if ent is None:
        return analytic
    try:
        blocks = tuple(int(b) for b in ent["blocks"])
    except (KeyError, TypeError, ValueError):
        blocks = None
    if blocks not in candidates:
        raise ValueError(
            f"autotune cache {cache_path()}: entry {key!r} has blocks "
            f"{ent.get('blocks') if isinstance(ent, dict) else ent!r}, "
            f"which is not one of this shape's candidates "
            f"{sorted(candidates)}")
    return candidates[blocks]


# ---------------------------------------------------------------------------
# K3: the split of K
# ---------------------------------------------------------------------------

_WK = (1, 2, 4, 8, 16)
_KZ = (1, 2, 4, 8)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def gemm_key(M: int, K: int, N: int, dtype, scheme: str = "tile",
             group_size: int = 32, aligned: bool = True) -> str:
    return (f"cuda:{card()}:gemm:{M}x{K}x{N}:"
            f"{_dtype_name(dtype)}:{scheme}:g{group_size}:"
            f"{'aligned' if aligned else 'unaligned'}")


def gemm_candidates(M: int, K: int, N: int, dtype, scheme: str = "tile",
                    group_size: int = 32, aligned: bool = True) -> dict:
    """{(mt, wk, kz): Plan} of K3's launches for these operands, in the
    regime ``lut_dequant_gemm.plan`` takes.  Small M: the plan's row
    tiling mt, every wk in 1..16 warps that a block of that tiling holds
    and kz in 1..8 blocks with at least 2 K steps of 16 per warp (the set
    ``scripts/sweep_gemm.py`` sweeps); large M: kz in 1..8 with K / 32 >=
    8 kz; the CUDA-core kernel: its one launch.  The plan's own launch is
    always one (at K 512 large M, the plan's kz 4 has only 4 K tiles of
    32 a block)."""
    from repro_torch.kernels import lut_dequant_gemm as G

    pl = G.plan(M, K, N, dtype, scheme, group_size, aligned)
    if pl.regime == "small_m":
        max_wk = 16 if pl.mt <= 2 else 8  # 512 or 256 threads a block
        plans = [G.Plan("small_m", pl.mt, wk, kz) for wk in _WK
                 for kz in _KZ if wk <= max_wk and K // 16 >= 2 * wk * kz]
    elif pl.regime == "large_m":
        plans = [G.Plan("large_m", 0, 0, kz) for kz in _KZ
                 if K // 32 >= 8 * kz]
    else:
        plans = []
    out = {(p.mt, p.wk, p.kz): p for p in plans}
    out.setdefault((pl.mt, pl.wk, pl.kz), pl)
    return out


def gemm_plan(M: int, K: int, N: int, dtype, scheme: str = "tile",
              group_size: int = 32, aligned: bool = True):
    """The ``lut_dequant_gemm.Plan`` that K3 launches for these operands:
    a measured entry of this card, else ``lut_dequant_gemm.plan``."""
    memo = (0, M, K, N, dtype, scheme == "tile", group_size, aligned)
    got = _MEMO.get(memo)
    if got is None:
        from repro_torch.kernels import lut_dequant_gemm as G

        got = _MEMO[memo] = choose(
            gemm_key(M, K, N, dtype, scheme, group_size, aligned),
            gemm_candidates(M, K, N, dtype, scheme, group_size, aligned),
            G.plan(M, K, N, dtype, scheme, group_size, aligned))
    return got


# ---------------------------------------------------------------------------
# K5: the KV block
# ---------------------------------------------------------------------------


def attn_key(BH: int, Sq: int, Skv: int, D: int, bq_target: int = 128,
             bkv_target: int = 128) -> str:
    return (f"cuda:{card()}:attn:{BH}x{Sq}x{Skv}x{D}:"
            f"t{bq_target}x{bkv_target}")


def attn_candidates(BH: int, Sq: int, Skv: int, D: int, bq_target: int = 128,
                    bkv_target: int = 128) -> dict:
    """{(bq, bkv): (bq, bkv)}: bq the analytic one (the CUDA kernel's
    query rows per block are fixed, and bq changes nothing), bkv every
    block of :func:`block_candidates` up to the CUDA kernel's
    ``MAX_BKV``, and the analytic pair."""
    from repro_torch.kernels.lut_softmax_attention import MAX_BKV

    bq = pick_block(Sq, bq_target)
    out = {(bq, b): (bq, b) for b in block_candidates(Skv, MAX_BKV)}
    pair = (bq, pick_block(Skv, bkv_target))
    out.setdefault(pair, pair)
    return out


def attn_blocks(BH: int, Sq: int, Skv: int, D: int, *, bq_target: int = 128,
                bkv_target: int = 128) -> tuple[int, int]:
    """(bq, bkv) for ``lut_softmax_attention``: a measured entry of this
    card, else ``(pick_block(Sq, bq_target), pick_block(Skv,
    bkv_target))``.  One entry serves every exp mode, as in the JAX
    package."""
    memo = (1, BH, Sq, Skv, D, bq_target, bkv_target)
    got = _MEMO.get(memo)
    if got is None:
        got = _MEMO[memo] = choose(
            attn_key(BH, Sq, Skv, D, bq_target, bkv_target),
            attn_candidates(BH, Sq, Skv, D, bq_target, bkv_target),
            (pick_block(Sq, bq_target), pick_block(Skv, bkv_target)))
    return got


# ---------------------------------------------------------------------------
# K6: the load width
# ---------------------------------------------------------------------------

QUANTIZE_CANDIDATES = {(0,): False, (1,): True}


def quantize_key(K: int, N: int, dtype) -> str:
    return f"cuda:{card()}:quantize:{K}x{N}:{_dtype_name(dtype)}"


def quantize_wide(K: int, N: int, dtype) -> bool:
    """Whether K6 loads a (K, N) weight of ``dtype`` through 256-byte L2
    fetches: a measured entry of this card, else
    ``tile_quantize.wide_loads``."""
    memo = (2, K, N, dtype)
    got = _MEMO.get(memo)
    if got is None:
        import torch

        from repro_torch.kernels.tile_quantize import wide_loads

        got = _MEMO[memo] = choose(
            quantize_key(K, N, dtype), QUANTIZE_CANDIDATES,
            wide_loads(torch.empty((K, N), dtype=dtype, device="meta")))
    return got


# ---------------------------------------------------------------------------
# The measuring half: time every candidate on the card, record the fastest
# ---------------------------------------------------------------------------


def device_ms(fn: Callable[[], object], iters: int = 50,
              warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` (CUDA work on the current
    stream).  A sleep kernel holds the stream while the host queues the
    calls, so the CUDA events time them back to back on the device,
    without the host's launch overhead."""
    import torch

    fn()  # one-time set-up (library handles, per-shape plans) is not timed
    torch.cuda.synchronize()
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


def _cuda_device(device):
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"autotune measures kernels on a CUDA device, got "
                         f"{device} (no plain version is timed in their "
                         f"place)")
    return device


def _copies_past_l2(device, nbytes: int) -> int:
    """Copies of an operand of ``nbytes`` that a rotation needs so that
    each call finds its copy out of L2 (twice the L2)."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 50 << 20)
    return max(2, math.ceil(2 * l2 / max(nbytes, 1)))


def _measure(fns: Mapping[tuple, Callable[[], object]], iters: int,
             rounds: int) -> dict:
    """{candidate: median device ms over ``rounds``}, the candidates
    timed in turns within each round."""
    times = {c: [] for c in fns}
    for _ in range(rounds):
        for c, fn in fns.items():
            times[c].append(device_ms(fn, iters))
    return {c: statistics.median(t) for c, t in times.items()}


def _record_winner(key: str, ms: dict) -> None:
    best = min(ms, key=ms.get)
    record(key, best, ms[best] * 1e3)


def gemm_operands(M: int, K: int, N: int, *, dtype, scheme: str = "tile",
                  group_size: int = 32, device="cuda"):
    """Seeded K3 operands (x, codes, scales, codebook) on ``device``:
    random codes and scales, the q4_0 codebook."""
    import torch

    from repro_torch.quant.codebooks import get_codebook

    gen = torch.Generator(device=device).manual_seed(0)
    scales_shape = ((K // 2, N // (group_size // 2)) if scheme == "tile"
                    else (K // group_size, N))
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    codes = torch.randint(0, 256, (K, N // 2), generator=gen, device=device,
                          dtype=torch.uint8)
    scales = (torch.rand(scales_shape, generator=gen, device=device)
              * 0.02 + 0.001).to(torch.float16)
    return x, codes, scales, get_codebook("q4_0", device=device)


def tune_gemm(M: int, K: int, N: int, *, dtype=None, scheme: str = "tile",
              group_size: int = 32, device="cuda", iters: int = 50,
              rounds: int = 3) -> dict:
    """Time every K3 candidate (:func:`gemm_candidates`) at (M, K, N) on
    the card through ``lut_dequant_gemm._launch``, on seeded operands,
    and record the fastest under :func:`gemm_key`.  Each call reads its
    own copy of the weight, out of L2, as a served decode step does.
    Returns {Plan: device ms} (the median of ``rounds`` rounds of
    ``iters`` calls, the candidates in turns)."""
    import torch

    from repro_torch.kernels import lut_dequant_gemm as G

    device = _cuda_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    x, codes, scales, codebook = gemm_operands(
        M, K, N, dtype=dtype, scheme=scheme, group_size=group_size,
        device=device)
    n = _copies_past_l2(device, codes.numel() + scales.numel() * 2)
    weights = [(codes, scales)] + [(codes.clone(), scales.clone())
                                   for _ in range(n - 1)]
    out = torch.empty((M, N), dtype=dtype, device=device)
    cands = gemm_candidates(M, K, N, dtype, scheme, group_size, True)

    def launcher(pl):
        i = [0]

        def run():
            c, s = weights[i[0] % len(weights)]
            i[0] += 1
            G._launch(x, c, s, codebook, out, pl, scheme=scheme,
                      group_size=group_size)
        return run

    with torch.cuda.device(device):
        ms = _measure({b: launcher(p) for b, p in cands.items()}, iters,
                      rounds)
    _record_winner(gemm_key(M, K, N, dtype, scheme, group_size, True), ms)
    return {cands[b]: t for b, t in ms.items()}


def tune_attn(BH: int, Sq: int, Skv: int, D: int, *, kv_group: int = 1,
              causal: bool = True, device="cuda", iters: int = 20,
              rounds: int = 3) -> dict:
    """Time K5 in lut mode (the paper's) at every KV block of
    :func:`attn_candidates` on the card, on seeded fp16 q (BH, Sq, D) and
    k, v (BH / kv_group, Skv, D), and record the fastest under
    :func:`attn_key` (block targets 128, ``ops.flash_attention``'s).
    Returns {(bq, bkv): device ms}."""
    import torch

    from repro_torch.kernels import lut_softmax_attention as LA
    from repro_torch.kernels import ops

    device = _cuda_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((BH, Sq, D), generator=gen, device=device)
    k, v = (torch.randn((BH // kv_group, Skv, D), generator=gen,
                        device=device) for _ in range(2))
    q, k, v = (t.mul(0.5).to(torch.float16) for t in (q, k, v))
    lut = ops.exp_lut(device)
    cands = attn_candidates(BH, Sq, Skv, D)
    with torch.cuda.device(device):
        ms = _measure({b: (lambda b=b: LA.lut_softmax_attention(
            q, k, v, lut, causal=causal, bq=b[0], bkv=b[1], exp_mode="lut",
            kv_group=kv_group)) for b in cands}, iters, rounds)
    _record_winner(attn_key(BH, Sq, Skv, D), ms)
    return ms


def tune_quantize(K: int, N: int, *, dtype=None, device="cuda",
                  iters: int = 20, rounds: int = 3) -> dict:
    """Time K6 with either load (``tile_quantize._launch``) on a seeded
    (K, N) weight on the card and record the faster under
    :func:`quantize_key`.  Each call reads its own copy of the weight,
    out of L2, as a load of the model's weights does.  Returns {wide:
    device ms}."""
    import torch

    from repro_torch.kernels import tile_quantize as TK

    device = _cuda_device(device)
    dtype = torch.float32 if dtype is None else dtype
    gen = torch.Generator(device=device).manual_seed(0)
    w = (torch.randn((K, N), generator=gen, device=device)
         / math.sqrt(K)).to(dtype)
    ws = [w] + [w.clone() for _ in range(
        _copies_past_l2(device, w.numel() * w.element_size()) - 1)]

    def launcher(wide):
        i = [0]

        def run():
            i[0] += 1
            TK._launch(ws[i[0] % len(ws)], wide)
        return run

    with torch.cuda.device(device):
        ms = _measure({b: launcher(wide)
                       for b, wide in QUANTIZE_CANDIDATES.items()}, iters,
                      rounds)
    _record_winner(quantize_key(K, N, dtype), ms)
    return {QUANTIZE_CANDIDATES[b]: t for b, t in ms.items()}


reset()
