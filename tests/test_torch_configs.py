"""The port's registry against the JAX package's, and the transformer
family's geometries through the port's engines.

Every config of the JAX registry (full and smoke) equals the port's
field for field, MoE, the Mamba2 / zamba2 SSM configs and whisper-base
included, and the port's model API routes each of them; an unknown
family raises.  At smoke size,
from the JAX init carried across by ``repro_torch.bridge``: prefill and
greedy decode logits and tokens through the paged engine over fp and Q8
pools for gemma3 (5:1 local:global windows), stablelm, qwen2.5-14b,
command-r, llama3.2 and mixtral (a uniform window), the prompts longer
than the windows; internvl2's ``embeddings=`` prefill (patch_stub) on
the dense and the paged layout, with decode after it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import api as japi
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import transformer as TR
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig

TRANSFORMERS = [a for a in JR.list_archs()
                if JR.get_config(a).family == "transformer"]
SSMS = ["mamba2-130m", "zamba2-1.2b"]
# f32 on both sides, summed in other orders (~1e-6 on these logits); a Q8
# pool can turn that into one flipped KV code at a rounding boundary, one
# quantization step of that element (tests/test_torch_model.py)
ATOL = {"none": 1e-5, "q8": 2e-3}
BS, MAX_LEN = 8, 64
NO_STOP = (9999,)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("smoke", [False, True])
def test_registry_lists_the_transformer_family_field_equal(smoke):
    from repro_torch.models import mamba2

    from repro_torch.models import whisper

    assert R.list_archs() == JR.list_archs()
    assert len(TRANSFORMERS) == 9
    for arch in TRANSFORMERS + SSMS + ["whisper-base"]:
        want = JR.get_config(arch, smoke=smoke)
        got = R.get_config(arch, smoke=smoke)
        assert _fields(got) == _fields(want), arch
        assert api.get_model(got) is (
            TR if arch in TRANSFORMERS else
            whisper if arch == "whisper-base" else mamba2)


def test_later_families_raise_naming_their_slice():
    """Every family of the JAX package has its module now: encdec routes
    to Whisper; an unknown family and an unknown arch still raise."""
    from repro_torch.models import whisper

    assert api.get_model(ModelConfig(name="x", family="encdec")) is whisper
    with pytest.raises(ValueError, match="unknown model family"):
        api.get_model(ModelConfig(name="x", family="rnn"))
    with pytest.raises(KeyError):
        R.get_config("whisper-large")


def test_param_count_of_olmoe_matches_the_reference():
    """The full-width MoE config the card serves: 6.92 B parameters, 1.28 B
    active per token."""
    want, got = JR.get_config("olmoe-1b-7b"), R.get_config("olmoe-1b-7b")
    assert got.param_count() == want.param_count()
    assert got.param_count(active_only=True) == want.param_count(
        active_only=True)
    assert round(got.param_count() / 1e9, 2) == 6.92
    assert round(got.param_count(active_only=True) / 1e9, 2) == 1.28


@pytest.mark.parametrize("arch", SSMS)
def test_param_count_of_the_ssm_configs_matches_the_reference(arch):
    """The two SSM configs served at full width on the card: mamba2-130m
    and zamba2-1.2b (its shared block counted once)."""
    want, got = JR.get_config(arch), R.get_config(arch)
    assert got.param_count() == want.param_count()
    assert round(got.param_count() / 1e9, 2) == {"mamba2-130m": 0.13,
                                                 "zamba2-1.2b": 1.17}[arch]


def _pair(arch, kv, *, paged=True, seed=1):
    cfg = JR.get_config(arch, smoke=True)
    jp = japi.get_model(cfg).init_params(jax.random.key(seed), cfg)
    kw = dict(max_len=MAX_LEN, eos_id=2, pad_id=0, paged=paged)
    if paged:
        kw.update(block_size=BS, n_blocks=1 + 4 * (MAX_LEN // BS),
                  kv_quant=kv)
    return (JEngine(jp, cfg, **kw),
            DecodeEngine(bridge.params_from_jax(jax.device_get(jp),
                                                device="cpu"),
                         R.get_config(arch, smoke=True), **kw), cfg)


def _drive(jeng, teng, toks, lens, steps, embeddings=None):
    """Prefill (``embeddings`` for a patch_stub prefix), then ``steps``
    greedy decode steps of each engine (no stop id); the sampled tokens
    must agree.  Returns each side's (steps + 1, B, V) logits."""
    jst = jeng.prefill(jnp.asarray(toks), jnp.asarray(lens),
                       None if embeddings is None else
                       jnp.asarray(embeddings))
    tst = teng.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                       None if embeddings is None else
                       torch.from_numpy(embeddings))
    want, got = [np.asarray(jst.pending_logits)], \
        [tst.pending_logits.numpy()]
    for _ in range(steps):
        jst, jtok = jeng.step(jst, jax.random.key(0), JSampler(greedy=True),
                              stop_ids=NO_STOP)
        tst, ttok = teng.step(tst, None, SamplerConfig(greedy=True),
                              stop_ids=NO_STOP)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        want.append(np.asarray(jst.pending_logits))
        got.append(tst.pending_logits.numpy())
    return np.stack(want), np.stack(got)


DENSE = ("gemma3-1b", "stablelm-3b", "qwen2.5-14b", "command-r-35b",
         "llama3.2-1b", "mixtral-8x7b")


@pytest.mark.parametrize("kv", ["none", "q8"])
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_configs_prefill_decode_match_reference(arch, kv):
    """Ragged prompts of 21 and 9 tokens (past gemma3's window of 8 and
    mixtral's 16 once decoded), 6 greedy decode steps, paged engine."""
    jeng, teng, cfg = _pair(arch, kv)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(3, 300, (2, 21)).astype(np.int32)
    lens = np.array([21, 9], np.int32)
    want, got = _drive(jeng, teng, toks, lens, steps=6)
    np.testing.assert_allclose(got, want, atol=ATOL[kv])
    assert teng.pool.blocks_in_use == jeng.pool.blocks_in_use


@pytest.mark.parametrize("paged", [False, True])
def test_patch_stub_embeddings_prefill_matches_reference(paged):
    """internvl2-smoke: a (B, 5, d) patch prefix through ``patch_proj`` in
    place of the first 5 positions, dense and paged, then 4 greedy
    decode steps; a cached prefix with embeddings raises."""
    jeng, teng, cfg = _pair("internvl2-1b", "none", paged=paged, seed=2)
    rng = np.random.default_rng(5)
    toks = rng.integers(3, 300, (2, 12)).astype(np.int32)
    lens = np.array([12, 8], np.int32)
    emb = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want, got = _drive(jeng, teng, toks, lens, steps=4, embeddings=emb)
    np.testing.assert_allclose(got, want, atol=ATOL["none"])
    plain = teng.prefill(torch.from_numpy(toks), torch.from_numpy(lens))
    assert np.abs(plain.pending_logits.numpy() - got[0]).max() > 1e-3
    if paged:
        with pytest.raises(NotImplementedError):
            teng.prefill(torch.from_numpy(toks[:1, 4:]),
                         torch.tensor([4], dtype=torch.int32),
                         torch.from_numpy(emb[:1]),
                         cached_table=np.zeros((1, teng.table_width),
                                               np.int32),
                         cached_lens=np.array([4]))
    with pytest.raises(NotImplementedError):
        TR.trunk(teng.params, torch.from_numpy(toks), teng.cfg,
                 embeddings=torch.from_numpy(emb),
                 prefix={"k": torch.zeros(cfg.n_layers, 2, 8, 1, 8),
                         "v": torch.zeros(cfg.n_layers, 2, 8, 1, 8),
                         "len": torch.tensor([4, 4])})


@pytest.mark.parametrize("arch", sorted(R.list_archs()))
def test_cpu_serve_takes_every_listed_arch(arch, capsys):
    """``serve.py --arch`` for each listed config at smoke size on the CPU
    (continuous Best-of-N on a Q8 pool; the SSM families, which have no
    paged layout, on dense rows): every request completes and the pool
    drains.  whisper-base is refused before anything is built: neither
    the scheduler's requests nor the entry point take its frames."""
    from repro_torch.launch import serve

    if arch == "whisper-base":
        with pytest.raises(ValueError, match="frames"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--continuous", "--dry"])
        return
    pool = [] if arch in SSMS else ["--paged", "--kv-quant", "q8"]
    rows = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--continuous", *pool, "--dry"])
    assert rows[0]["serving"]["completed_requests"] == 2
    out = capsys.readouterr().out
    assert ("kv pool clean: 0 blocks" in out) == (arch not in SSMS)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b"])
def test_windowed_configs_on_the_dense_layout(arch):
    """The per-layer windows (gemma3's 5:1 local:global, mixtral's uniform
    16) on the dense KV rows: prompts past the window, greedy decode."""
    jeng, teng, cfg = _pair(arch, "none", paged=False)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, 300, (2, 21)).astype(np.int32)
    lens = np.array([21, 13], np.int32)
    want, got = _drive(jeng, teng, toks, lens, steps=6)
    np.testing.assert_allclose(got, want, atol=ATOL["none"])
