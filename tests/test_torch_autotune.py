"""``repro_torch.kernels.autotune``'s launch choices against the planners
they replace and the JAX package's ``kernels/autotune``.

With no measured entry each choice is the wrapper's own planner's
(``lut_dequant_gemm.plan``, ``pick_block``, ``tile_quantize.wide_loads``)
at every served shape; a recorded entry wins, survives a reset, and
``REPRO_AUTOTUNE=0`` restores the planner's; an entry that is not a
candidate raises; and one cache file holds both packages' entries without
either reading the other's.  CPU only: nothing launches a kernel."""
import importlib.util
import itertools
import json
from pathlib import Path

import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.configs import registry
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import tile_quantize as TK

ROOT = Path(__file__).resolve().parents[1]
M_GRID = (1, 8, 12, 32, 79, 512, 3000, 12000, 32704)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Both packages on an empty cache file of this test's own, tuning
    on; reset again after the test."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    AT.reset()
    jautotune.reset()
    yield path
    monkeypatch.undo()
    AT.reset()
    jautotune.reset()


def _served_kn(arch: str) -> set:
    """The (K, N) K3 takes for ``arch`` at full width: a forward's Q4
    projections (``chip_smoke.gemm_layout``; Whisper's encoder side too)
    and, for the families with a ``model`` layout of their own, the
    projections' blocks on ``model`` = 2; those that tile into the tile
    scheme's (2, 16) groups."""
    cfg = registry.get_config(arch)
    kn = set(CS.gemm_layout(cfg))
    if cfg.family == "encdec":
        kn |= set(CS.encoder_gemm_layout(cfg))
    if cfg.family in ("encdec", "mamba2", "hybrid"):
        for part in ("decoder", "encoder"):
            kn |= set(CS.tp_gemm_layout(cfg, 2, part))
    return {(k, n) for k, n in kn if k % 2 == 0 and n % 16 == 0}


TILING_ARCHS = [a for a in registry.list_archs() if _served_kn(a)]


def test_every_arch_has_served_shapes():
    assert len(TILING_ARCHS) == len(registry.list_archs())
    assert {(1536, 1536), (1536, 256), (1536, 8960)} <= _served_kn(
        "qwen2.5-1.5b")


@pytest.mark.parametrize("arch", TILING_ARCHS)
def test_gemm_plan_is_plan_without_entries(arch):
    """No measured entry: K3 launches ``lut_dequant_gemm.plan``'s launch
    at every served shape, M, dtype, scale scheme and alignment, and that
    launch is one of the shape's candidates."""
    n = 0
    for (K, N), M, dtype, scheme, aligned in itertools.product(
            sorted(_served_kn(arch)), M_GRID, DTYPES, G.SCHEMES,
            (True, False)):
        want = G.plan(M, K, N, dtype, scheme, 32, aligned)
        for _ in range(2):  # a miss, then the memo
            assert AT.gemm_plan(M, K, N, dtype, scheme, 32, aligned) == \
                want, (M, K, N, dtype, scheme, aligned)
        cands = AT.gemm_candidates(M, K, N, dtype, scheme, 32, aligned)
        assert cands[want.mt, want.wk, want.kz] == want
        assert {p.regime for p in cands.values()} == {want.regime}
        n += 1
    assert n >= 9 * 3 * 2 * 2


@pytest.mark.parametrize("M,K,N,want", [
    # small M: the sweep's set, wk up to a block's warps, >= 2 K steps of
    # 16 per warp
    (8, 1536, 8960, 17), (32, 1536, 1536, 15), (8, 64, 320, 3),
    # large M: kz 1..8 with K / 32 >= 8 kz, plus the plan's own kz 4 at
    # K 512
    (32704, 1536, 8960, 3), (40, 512, 256, 3),
    # f32: the CUDA-core kernel's one launch
    (8, 1536, 1536, 1)])
def test_gemm_candidates(M, K, N, want):
    dtype = torch.float32 if want == 1 else torch.bfloat16
    cands = AT.gemm_candidates(M, K, N, dtype)
    assert len(cands) == want
    for (mt, wk, kz), p in cands.items():
        assert (p.mt, p.wk, p.kz) == (mt, wk, kz)
        if p.regime == "small_m":
            assert wk * 32 <= (512 if mt <= 2 else 256)
            assert K // 16 >= 2 * wk * kz
        elif (p.mt, p.wk, p.kz) != tuple(G.plan(M, K, N, dtype)[1:]):
            assert K // 32 >= 8 * kz


def _attn_grid():
    return itertools.product((1, 12, 96), (1, 8, 16, 79, 128, 130, 256, 2048),
                             (8, 79, 100, 128, 256, 1024, 2048, 32768),
                             (32, 64, 128))


def test_attn_blocks_match_jax_without_entries():
    """No measured entry: ``attn_blocks`` is today's ``pick_block`` pair
    and equals the JAX package's analytic ``attn_blocks``."""
    n = 0
    for BH, Sq, Skv, D in _attn_grid():
        want = (AT.pick_block(Sq, 128), AT.pick_block(Skv, 128))
        got = AT.attn_blocks(BH, Sq, Skv, D)
        assert got == want == tuple(jautotune.attn_blocks(BH, Sq, Skv, D)), \
            (BH, Sq, Skv, D)
        assert got in AT.attn_candidates(BH, Sq, Skv, D)
        n += 1
    assert n == 3 * 8 * 8 * 3


def test_attn_blocks_keep_pick_block_where_jax_scores_otherwise(monkeypatch):
    """Where KV has no block in (1, 128] (a prime Skv above 128), the JAX
    package's roofline scorer takes bkv 1 and its ``REPRO_AUTOTUNE=0``
    path ``pick_block``'s Skv; the port keeps ``pick_block``, the launch
    it made before it had a tuner."""
    for Skv in (131, 1031):
        want = (8, Skv)
        assert AT.attn_blocks(12, 8, Skv, 64) == want
        assert tuple(jautotune.attn_blocks(12, 8, Skv, 64)) == (8, 1)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    jautotune.reset()
    assert tuple(jautotune.attn_blocks(12, 8, 1031, 64)) == (8, 1031)


@pytest.mark.parametrize("case", [(1, 128, 128, 4, 2, 64),
                                  (2, 79, 256, 4, 4, 32)])
def test_flash_attention_launches_attn_blocks(case, cache, monkeypatch):
    """``ops.flash_attention`` hands its wrapper ``attn_blocks``' KV block:
    ``pick_block``'s without an entry, the recorded one with it."""
    B, Sq, Skv, Hq, Hkv, D = case
    seen = []
    wrapper = ops._attn.lut_softmax_attention

    def spy(*a, bkv, **kw):
        seen.append(bkv)
        return wrapper(*a, bkv=bkv, **kw)

    monkeypatch.setattr(ops._attn, "lut_softmax_attention", spy)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((B, Sq, Hq, D), generator=gen)
    k, v = (torch.randn((B, Skv, Hkv, D), generator=gen) for _ in range(2))
    ops.flash_attention(q, k, v)
    AT.record(AT.attn_key(B * Hq, Sq, Skv, D), (AT.pick_block(Sq, 128), 64),
              1.0)
    out = ops.flash_attention(q, k, v)
    assert seen == [AT.pick_block(Skv, 128), 64]
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_wide_is_wide_loads_without_entries(dtype):
    for K, N in itertools.product((2, 1536, 2048, 4096),
                                  (32, 256, 1536, 2048, 2720, 5504, 8960)):
        w = torch.empty((K, N), dtype=dtype, device="meta")
        assert AT.quantize_wide(K, N, dtype) == TK.wide_loads(w), (K, N)
    assert AT.quantize_wide(1536, 8960, torch.float32)
    assert not AT.quantize_wide(1536, 1536, torch.float32)


# (kernel, its choice function at one shape, the key, a candidate other
# than the analytic one as recorded, that choice, a non-candidate)
CHOICES = {
    "gemm": (lambda: AT.gemm_plan(16, 1024, 1024, torch.bfloat16),
             lambda: AT.gemm_key(16, 1024, 1024, torch.bfloat16),
             (2, 2, 4), G.Plan("small_m", 2, 2, 4), (2, 16, 8)),
    "attn": (lambda: AT.attn_blocks(8, 256, 256, 64),
             lambda: AT.attn_key(8, 256, 256, 64), (128, 64), (128, 64),
             (128, 100)),
    "quantize": (lambda: AT.quantize_wide(1536, 1536, torch.float32),
                 lambda: AT.quantize_key(1536, 1536, torch.float32), (1,),
                 True, (2,)),
}


@pytest.mark.parametrize("kernel", sorted(CHOICES))
def test_recorded_entry_roundtrip(kernel, cache, monkeypatch):
    """The JAX package's round trip: a recorded entry is picked up at
    once, survives a fresh load, and ``REPRO_AUTOTUNE=0`` restores the
    analytic choice."""
    choice, key, blocks, tuned, _ = CHOICES[kernel]
    analytic = choice()
    assert analytic != tuned
    AT.record(key(), blocks, 12.5)
    assert choice() == tuned
    AT.reset()
    assert choice() == tuned
    ent = json.loads(cache.read_text())
    assert ent["version"] == 1
    assert ent["entries"][key()] == {"blocks": list(blocks), "us": 12.5,
                                     "source": "measured"}
    assert key().startswith(f"cuda:{AT.card()}:")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert choice() == tuned  # the environment is read at reset()
    AT.reset()
    assert choice() == analytic
    monkeypatch.delenv("REPRO_AUTOTUNE")
    AT.reset()
    assert choice() == tuned


@pytest.mark.parametrize("kernel", sorted(CHOICES))
def test_entry_that_is_not_a_candidate_raises(kernel, cache):
    choice, key, _, _, bad = CHOICES[kernel]
    AT.record(key(), bad, 1.0)
    with pytest.raises(ValueError, match="not one of this shape's "
                                         "candidates") as err:
        choice()
    assert str(cache) in str(err.value) and key() in str(err.value)
    cache.write_text(json.dumps({"version": 1, "entries": {
        key(): {"blocks": "x"}}}))
    AT.reset()
    with pytest.raises(ValueError, match="not one of"):
        choice()


@pytest.mark.parametrize("text", [None, "", "{", "[1, 2]",
                                  '{"entries": 3}'])
def test_missing_or_unreadable_cache_is_empty(text, cache):
    if text is not None:
        cache.write_text(text)
    assert AT.gemm_plan(8, 1536, 8960, torch.bfloat16) == \
        G.plan(8, 1536, 8960, torch.bfloat16)
    AT.record(AT.gemm_key(8, 1536, 8960, torch.bfloat16), (1, 4, 2), 3.0)
    assert AT.gemm_plan(8, 1536, 8960, torch.bfloat16) == \
        G.Plan("small_m", 1, 4, 2)


def test_one_cache_file_for_both_packages(cache):
    """The port's entry at gemm:16x1024x1024's shape and the JAX
    package's at its own key live in one file: each package reads its own
    entry, and each ``record`` keeps the other's."""
    port_key = AT.gemm_key(16, 1024, 1024, torch.bfloat16)
    jax_key = jautotune.gemm_key(16, 1024, 1024, "tile", 32)
    assert port_key != jax_key and port_key.startswith("cuda:")
    AT.record(port_key, (2, 4, 2), 5.0)
    jautotune.reset()
    jautotune.record(jax_key, (16, 64, 32), 12.5)
    entries = json.loads(cache.read_text())["entries"]
    assert set(entries) == {port_key, jax_key}  # the JAX record kept ours
    AT.reset()
    assert AT.gemm_plan(16, 1024, 1024, torch.bfloat16) == \
        G.Plan("small_m", 2, 4, 2)
    assert tuple(jautotune.gemm_blocks(16, 1024, 1024, scheme="tile")) == \
        (16, 64, 32)
    AT.record(AT.attn_key(8, 256, 256, 64), (128, 64), 7.0)  # keeps JAX's
    entries = json.loads(cache.read_text())["entries"]
    assert entries[jax_key]["blocks"] == [16, 64, 32]
    del entries[jax_key]
    cache.write_text(json.dumps({"version": 1, "entries": entries}))
    jautotune.reset()
    AT.reset()
    assert tuple(jautotune.gemm_blocks(16, 1024, 1024, scheme="tile")) == \
        (16, 256, 128)
    assert AT.gemm_plan(16, 1024, 1024, torch.bfloat16) == \
        G.Plan("small_m", 2, 4, 2)


@pytest.mark.parametrize("tune", [
    lambda: AT.tune_gemm(8, 64, 64, device="cpu"),
    lambda: AT.tune_attn(4, 64, 64, 32, device="cpu"),
    lambda: AT.tune_quantize(64, 64, device="cpu")],
    ids=["gemm", "attn", "quantize"])
def test_tune_refuses_the_cpu(tune, cache):
    with pytest.raises(ValueError, match="CUDA device"):
        tune()
    assert not cache.exists()


def test_gemm_operands_shapes():
    x, codes, scales, codebook = AT.gemm_operands(
        8, 64, 96, dtype=torch.bfloat16, device="cpu")
    assert (x.shape, x.dtype) == ((8, 64), torch.bfloat16)
    assert (codes.shape, codes.dtype) == ((64, 48), torch.uint8)
    assert (scales.shape, scales.dtype) == ((32, 6), torch.float16)
    assert codebook.shape == (16,)
    got = G.lut_dequant_gemm(x, codes, scales, codebook)
    assert got.shape == (8, 96) and torch.isfinite(got.float()).all()
    _, _, sc, _ = AT.gemm_operands(8, 64, 96, dtype=torch.float32,
                                   scheme="common", device="cpu")
    assert sc.shape == (2, 96)
