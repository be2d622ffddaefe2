"""Continuous Best-of-N serving in the port against the JAX package: the
same weights (via ``repro_torch.bridge``), tasks and greedy sampling must
give identical samples, decode-token counts and accuracy rows, over fp, Q8
and Q4 pools with fp and W4A16 weights, and the pool must drain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as JC
from repro.core.reward import OracleVerifier as JOracle
from repro.models import api as japi
from repro.models import transformer as JT
from repro.quant.qlinear import quantize_model_params as jax_quantize
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.core import controller as C
from repro_torch.core.reward import OracleVerifier
from repro_torch.data import tasks as T
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig

# f32 logits of the two packages differ by ~1e-6; a greedy pick is only
# decidable where the reference's top-2 margin clears this bar
MARGIN_TOL = 1e-4


def _capture(monkeypatch, module):
    """Record the schedulers ``module.serve_best_of_n`` builds."""
    made = []
    base = module.ContinuousScheduler

    class Capturing(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, "ContinuousScheduler", Capturing)
    return made


def _samples(sched, n_tasks):
    return [[s.tokens for s in sorted(sched.completed[i],
                                      key=lambda s: s.sample_idx)]
            for i in range(n_tasks)]


def _explain_divergence(jparams, cfg, tok, tasks, want, got):
    """The reference's top-2 margin at the first diverging greedy pick."""
    for i, (ws, gs) in enumerate(zip(want, got)):
        for w, g in zip(ws, gs):
            if w == g:
                continue
            k = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b),
                     min(len(w), len(g)))
            ids = tok.encode(tasks[i].prompt) + w[:k]
            logits, _, _ = JT.forward(jparams, jnp.asarray([ids]), cfg)
            top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
            margin = float(top2[1] - top2[0])
            kind = ("a near-tie the two packages may legitimately break "
                    "differently" if margin < MARGIN_TOL else
                    "a clear margin, so this is a port fault")
            return (f"task {i} diverges at token {k}: reference top-2 "
                    f"margin {margin:.2e} vs tolerance {MARGIN_TOL:.0e} — "
                    f"{kind}")
    return "samples differ"


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


def _serve_both(monkeypatch, tok, cfg, jparams, kv, *, n, n_slots,
                max_tokens, block_size, n_blocks, n_tasks=2):
    tasks = T.gen_dataset(123, n_tasks)
    j_made = _capture(monkeypatch, JC)
    t_made = _capture(monkeypatch, C)
    jeng = JEngine(jparams, cfg, max_len=64, eos_id=tok.eos_id,
                   pad_id=tok.pad_id, paged=True, block_size=block_size,
                   n_blocks=n_blocks, kv_quant=kv)
    want = JC.serve_best_of_n(jeng, tok, tasks, n=n, max_tokens=max_tokens,
                              rng=jax.random.key(0), scorer=JOracle(),
                              n_slots=n_slots, sc=JSampler(greedy=True))
    teng = DecodeEngine(bridge.params_from_jax(jax.device_get(jparams),
                                               device="cpu"),
                        _torch_cfg(cfg), max_len=64, eos_id=tok.eos_id,
                        pad_id=tok.pad_id, paged=True, block_size=block_size,
                        n_blocks=n_blocks, kv_quant=kv)
    got = C.serve_best_of_n(teng, tok, tasks, n=n, max_tokens=max_tokens,
                            rng=torch.Generator().manual_seed(0),
                            scorer=OracleVerifier(), n_slots=n_slots,
                            sc=SamplerConfig(greedy=True))
    ws, gs = _samples(j_made[-1], n_tasks), _samples(t_made[-1], n_tasks)
    assert gs == ws, _explain_divergence(jparams, cfg, tok, tasks, ws, gs)
    for key in ("method", "budget", "accuracy", "decode_tokens"):
        assert got[key] == want[key], key
    for key in ("steps", "decode_tokens", "prefill_tokens", "preemptions",
                "completed_requests", "completed_samples", "peak_kv_bytes"):
        assert got["serving"][key] == want["serving"][key], key
    assert teng.pool.blocks_in_use == 0  # drained: no leaked blocks
    return got


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
@pytest.mark.parametrize("w4a16", [False, True])
def test_serve_best_of_n_matches_reference(monkeypatch, tok, tiny_cfg, kv,
                                           w4a16):
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(7), tiny_cfg)
    if w4a16:
        jp = jax_quantize(jp)
    got = _serve_both(monkeypatch, tok, tiny_cfg, jp, kv, n=3, n_slots=4,
                      max_tokens=8, block_size=8, n_blocks=64)
    assert got["serving"]["completed_requests"] == 2
    assert got["serving"]["kv"]["kv_quant"] == kv


def test_starved_pool_preempts_like_reference(monkeypatch, tok, tiny_cfg):
    """Two Best-of-2 groups decode at once on a pool too small for both:
    the youngest is preempted and rerun, with identical outputs and
    preemption counts in both packages, and the pool drains."""
    jp = jax_quantize(japi.get_model(tiny_cfg).init_params(
        jax.random.key(8), tiny_cfg))
    got = _serve_both(monkeypatch, tok, tiny_cfg, jp, "q8", n=2, n_slots=4,
                      max_tokens=16, block_size=4, n_blocks=14, n_tasks=3)
    assert got["serving"]["preemptions"] > 0
