"""The port's single-device training against the JAX package's, on the
same bridged params and seeded numpy batches, f32 on both sides.

Params are the port's seeded init, laid out for the JAX package by
``bridge.params_to_jax`` (whose tree must be the reference init's).
``lm_loss`` and every grad leaf of one step against
``jax.value_and_grad`` of the reference's ``lm_loss``, on ``tiny_cfg``
and on smoke configs of a dense transformer, olmoe (MoE: the aux term
included), internvl2 (``patch_stub`` embeddings), mamba2, zamba2 and
whisper (frames); ``adamw_update`` (decay mask, clip or none) and
``lr_at`` (warmup, mid, end of the three schedules) within 1e-6; a
``microbatches=2`` step against the reference's; three ``train_loop``
steps from the same params and loader; the data loader byte for byte;
``reward_loss`` and its grads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import reward as JRW
from repro.data.dataset import MathDataLoader as JLoader
from repro.data.dataset import pack_documents as jpack
from repro.train import loop as JTL
from repro.train import optimizer as JO
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import registry as R
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reward as RW
from repro_torch.data.dataset import MathDataLoader, pack_documents
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import api
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4   # of each leaf's largest |grad|
ADAM_ATOL = 1e-6
B, S = 2, 12
# Adam divides each moment by its own magnitude: a grad element within
# the two packages' rounding of zero becomes a step of up to lr in an
# arbitrary direction at eps 1e-8.  The steps compared after an update
# use eps 1e-5, which damps such elements and leaves the others normed.
ADAM_EPS = 1e-5
# families of the smoke configs: a dense transformer, MoE, patch_stub,
# Mamba2, the zamba2 hybrid, Whisper
ARCHS = ["tiny", "qwen2.5-1.5b", "olmoe-1b-7b", "internvl2-1b",
         "mamba2-130m", "zamba2-1.2b", "whisper-base"]


def _port(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def _cfgs(arch, tiny_cfg):
    """(JAX cfg, port cfg), f32 compute and params."""
    if arch == "tiny":
        jc = tiny_cfg
        tc = ModelConfig(**dataclasses.asdict(tiny_cfg))
    else:
        jc, tc = JR.get_config(arch, smoke=True), R.get_config(arch,
                                                               smoke=True)
    f32 = dict(dtype="float32", param_dtype="float32")
    return dataclasses.replace(jc, **f32), dataclasses.replace(tc, **f32)


def _batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    out = [rng.integers(3, 300, (b, S)).astype(np.int32),
           rng.integers(3, 300, (b, S)).astype(np.int32),
           (rng.random((b, S)) > 0.2).astype(np.float32)]
    if cfg.family == "encdec":
        out.append(rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    elif cfg.frontend == "patch_stub":
        out.append(rng.standard_normal((b, 4, cfg.d_model)).astype(
            np.float32))
    return out


def assert_trees_close(got, want, rtol, what=""):
    """Each leaf within ``rtol`` of its largest magnitude.  A leaf whose
    exact value is zero (a key projection's bias: softmax ignores a shift
    shared by every key) holds only rounding, so the scale is floored at
    1e-3 of the tree's largest leaf."""
    got_l = T.stacked_leaves(got)
    want_l = T.stacked_leaves(want)
    assert [p for p, *_ in got_l] == [p for p, *_ in want_l], what
    top = max(float(torch.stack(w).abs().max()) for _, w, _ in want_l)
    for (path, g, _), (_, w, _) in zip(got_l, want_l):
        g, w = torch.stack(g), torch.stack(w)
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = float((g - w).abs().max())
        assert err <= rtol * scale, f"{what}{path}: {err} vs {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, tiny_cfg):
    jc, tc = _cfgs(arch, tiny_cfg)
    tp = api.get_model(tc).init_params(tc, seed=1, device="cpu")
    jp = bridge.params_to_jax(tp)
    batch = _batch(jc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JTL.lm_loss(p, b, jc, None), has_aux=True))(
            jp, tuple(jnp.asarray(b) for b in batch))
    (tl, tm), tg = TL.value_and_grad(
        tp, tuple(torch.from_numpy(b) for b in batch), tc)
    for name, a, b in (("total", tl, jl), ("loss", tm["loss"], jm["loss"]),
                       ("aux", tm["aux"], jm["aux"])):
        assert abs(float(a) - float(b)) <= LOSS_RTOL * max(
            abs(float(b)), 1e-6), (name, float(a), float(b))
    assert float(tm["tokens"]) == float(jm["tokens"])
    if arch == "olmoe-1b-7b":
        assert float(tm["aux"]) > 0
    assert_trees_close(tg, _port(jg), GRAD_RTOL, f"{arch}: ")


def _adam_case(seed, oc_kw):
    rng = np.random.default_rng(seed)
    params = {"layers": {"attn": {"wq": {"w": rng.standard_normal(
                  (2, 8, 8)).astype(np.float32),
                  "b": rng.standard_normal((2, 8)).astype(np.float32)}},
                  "attn_norm": {"scale": rng.standard_normal(
                      (2, 8)).astype(np.float32)},
                  "A_log": rng.standard_normal((2, 4)).astype(np.float32)},
              "embedding": {"table": rng.standard_normal((16, 8)).astype(
                  np.float32)},
              "enc_norm": {"bias": rng.standard_normal((8,)).astype(
                  np.float32)}}
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 3, params)
    return params, grads, O.AdamWConfig(**oc_kw), JO.AdamWConfig(**oc_kw)


@pytest.mark.parametrize("oc_kw", [
    dict(lr=1e-2, warmup_steps=2, total_steps=10),             # clipped
    dict(lr=1e-2, warmup_steps=0, total_steps=10, grad_clip=0.0),
    dict(lr=3e-3, weight_decay=0.1, grad_clip=100.0, schedule="linear",
         warmup_steps=1, total_steps=5)], ids=["clip", "no_clip", "decay"])
def test_adamw_update_matches_jax(oc_kw):
    """Three updates from zero moments: params, m, v, step, lr and the
    grad norm, with the decay mask (norm ``scale`` / ``bias`` and
    ``A_log`` not decayed)."""
    params, grads, oc, joc = _adam_case(0, oc_kw)
    jp, jo = params, JO.init_opt_state(params)
    tp = _port(params)
    to = O.init_opt_state(tp)
    jupdate = jax.jit(JO.adamw_update, static_argnums=3)
    for _ in range(3):
        jp, jo, jm = jupdate(jp, grads, jo, joc)
        tp, to, tm = O.adamw_update(tp, _port(grads), to, oc)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for (path, g, _), (_, w, _) in zip(T.stacked_leaves(got),
                                           T.stacked_leaves(_port(want))):
            # v holds squares up to ~80: 1e-6 relative there, one f32 ulp
            np.testing.assert_allclose(torch.stack(g).numpy(),
                                       torch.stack(w).numpy(),
                                       atol=ADAM_ATOL, rtol=ADAM_ATOL,
                                       err_msg=path)
    assert int(to["step"]) == int(jo["step"]) == 3
    for k in ("lr", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= ADAM_ATOL * max(
            1.0, abs(float(jm[k]))), k
    # the mask: a norm scale moves by Adam alone, a weight with decay too
    assert O._decay_mask(("layers", 0, "attn", "wq", "w"))
    assert not any(O._decay_mask(("x", k)) for k in O._NO_DECAY)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(lr=2e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    oc, joc = O.AdamWConfig(**kw), JO.AdamWConfig(**kw)
    for step in (0, 5, 10, 37, 55, 99, 100, 130):  # warmup, mid, end
        want = float(JO.lr_at(jnp.asarray(step, jnp.int32), joc))
        assert abs(float(O.lr_at(step, oc)) - want) <= ADAM_ATOL, step
        assert abs(float(O.lr_at(torch.tensor(step, dtype=torch.int32),
                                 oc)) - want) <= ADAM_ATOL, step


@pytest.fixture(scope="module")
def tiny_pair(tok, tiny_cfg):
    """JAX-layout params of ``tiny_cfg`` (the port's seeded init, stacked
    by ``bridge.params_to_jax``) and the JAX cfg's port twin."""
    tc = ModelConfig(**dataclasses.asdict(tiny_cfg))
    return bridge.params_to_jax(api.get_model(tc).init_params(
        tc, seed=0, device="cpu")), tc


def test_microbatched_step_matches_jax(tiny_pair, tiny_cfg):
    """``microbatches=2`` accumulates f32 grads over two halves in order:
    one step's params, loss and metrics against the reference's."""
    jp, tc = tiny_pair
    oc = dict(lr=1e-3, warmup_steps=0, eps=ADAM_EPS)
    batch = _batch(tiny_cfg, seed=4, b=4)
    jstep = JTL.make_train_step(tiny_cfg, JO.AdamWConfig(**oc), None,
                                microbatches=2)
    jp2, _, jm = jax.jit(jstep)(jp, JO.init_opt_state(jp),
                                tuple(jnp.asarray(b) for b in batch))
    tp = _port(jp)
    tstep = TL.make_train_step(tc, O.AdamWConfig(**oc), microbatches=2)
    tp2, _, tm = tstep(tp, O.init_opt_state(tp),
                       tuple(torch.from_numpy(b) for b in batch))
    assert_trees_close(tp2, _port(jp2), 1e-5, "params ")
    for k in ("total_loss", "loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(
            float(jm[k])), k


def test_three_train_loop_steps_match_jax(tok, tiny_pair, tiny_cfg):
    """``train_loop`` from the same params over the same loader (seed 3):
    the params after three steps within 1e-4."""
    jp, tc = tiny_pair
    oc = dict(lr=2e-3, warmup_steps=1, total_steps=10, eps=ADAM_EPS)
    jl = JLoader(tok, batch_size=4, seq_len=32, seed=3)
    tl = MathDataLoader(ByteTokenizer(), batch_size=4, seq_len=32, seed=3)
    try:
        jout, _ = JTL.train_loop(jp, tiny_cfg, JO.AdamWConfig(**oc), jl,
                                 n_steps=3, log_every=0)
        logs = []
        tout, topt = TL.train_loop(_port(jp), tc, O.AdamWConfig(**oc), tl,
                                   n_steps=3, log_every=1,
                                   log_fn=logs.append)
    finally:
        jl.close()
        tl.close()
    assert int(topt["step"]) == 3 and len(logs) == 3
    for (path, g, _), (_, w, _) in zip(T.stacked_leaves(tout),
                                       T.stacked_leaves(_port(jout))):
        np.testing.assert_allclose(torch.stack(g).numpy(),
                                   torch.stack(w).numpy(), atol=1e-4,
                                   rtol=0, err_msg=path)


def test_data_loader_is_the_reference_byte_for_byte(tok):
    """Same seed and arguments: equal batches; two hosts' streams are
    disjoint; ``pack_documents`` equal with and without prompt loss."""
    docs = [("Q:1+1=?A:", "2."), ("Q:7*3=?A:", "21."), ("x", "y" * 40)]
    for lp in (False, True):
        for a, b in zip(pack_documents(docs, ByteTokenizer(), 16,
                                       loss_prompt=lp),
                        jpack(docs, tok, 16, loss_prompt=lp)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    loaders = [MathDataLoader(ByteTokenizer(), batch_size=4, seq_len=32,
                              seed=7, host_id=h, n_hosts=2)
               for h in (0, 1)]
    ref = JLoader(tok, batch_size=4, seq_len=32, seed=7, host_id=0,
                  n_hosts=2)
    try:
        for _ in range(3):
            got, want = next(loaders[0]), next(ref)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        other = next(loaders[1])
        assert got[0].tobytes() != other[0].tobytes()
    finally:
        for ld in loaders + [ref]:
            ld.close()


def test_reward_loss_and_grads_match_jax():
    cfg = JRW.reward_config(320)
    tp = RW.init_reward_params(RW.reward_config(320), seed=2, device="cpu")
    jp = {"trunk": bridge.params_to_jax(tp["trunk"]),
          "head": bridge.params_to_jax(tp["head"])}
    rng = np.random.default_rng(6)
    toks = rng.integers(3, 300, (4, 10)).astype(np.int32)
    lens = np.array([10, 3, 7, 9], np.int32)
    labels = np.array([1, 0, 1, 0], np.float32)
    jl, jg = jax.jit(jax.value_and_grad(JRW.reward_loss),
                     static_argnums=4)(
        jp, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(labels), cfg)
    leaves, spec = T.flatten(tp)
    ps = [p.requires_grad_(True) for p in leaves]
    tl = RW.reward_loss(T.unflatten(spec, ps), torch.from_numpy(toks),
                        torch.from_numpy(lens), torch.from_numpy(labels),
                        RW.reward_config(320))
    tg = T.unflatten(spec, list(torch.autograd.grad(tl, ps)))
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_RTOL * float(jl)
    want = RW.bridge_reward_params(jax.device_get(jg), device="cpu")
    assert_trees_close(tg, want, GRAD_RTOL, "reward ")
