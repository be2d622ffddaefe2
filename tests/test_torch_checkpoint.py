"""The port's checkpointer, fault tolerance and training entry point.

Checkpoints cross between the packages in both directions, bit for bit:
the JAX package's ``Checkpointer`` saves and the port's restores into its
per-layer lists, and the other way round, on a transformer, an MoE, a
hybrid, a Whisper tree, a W4A16 tree and a training state {"params",
"opt", "step"}.  Then the contract ``tests/test_train_checkpoint.py``
holds the reference to (gc / latest, async save, ``resume_or_init``,
``PreemptionHandler``, ``StragglerMonitor``), bfloat16 leaves and an
unreadable leaf, ``launch.train`` resuming after a relaunch, and
``serve.py --ckpt`` / ``--cache-capacity``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import registry as JR
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import api as japi
from repro.quant.qlinear import quantize_model_params as jquantize
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as R
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerMonitor,
                                                     resume_or_init)
from repro_torch.models import api
from repro_torch.quant.qlinear import quantize_model_params
from repro_torch.train.optimizer import init_opt_state

TREES = ["transformer", "moe", "hybrid", "whisper", "w4a16", "train_state"]
ARCH = {"transformer": "qwen2.5-1.5b", "moe": "olmoe-1b-7b",
        "hybrid": "zamba2-1.2b", "whisper": "whisper-base"}


def _tiny():
    return dict(name="tiny", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=192, vocab_size=320,
                dtype="float32", param_dtype="float32", remat="none")


def _trees(kind):
    """(port tree, the JAX package's abstract tree of the same layout)."""
    if kind in ARCH:
        jc = JR.get_config(ARCH[kind], smoke=True)
        tc = R.get_config(ARCH[kind], smoke=True)
    else:
        jc, tc = JModelConfig(**_tiny()), ModelConfig(**_tiny())
    tp = api.get_model(tc).init_params(tc, seed=4, device="cpu")

    def jinit():
        return japi.get_model(jc).init_params(jax.random.key(0), jc)

    if kind == "w4a16":
        return quantize_model_params(tp), jax.eval_shape(
            lambda: jquantize(jinit()))
    if kind == "train_state":
        opt = init_opt_state(tp)
        opt["m"] = T.map_with_path(lambda _, p: p * 0.5, tp)
        opt["step"] = torch.tensor(7, dtype=torch.int32)
        return ({"params": tp, "opt": opt,
                 "step": torch.tensor(7, dtype=torch.int32)},
                jax.eval_shape(lambda: {"params": jinit(),
                                        "opt": jinit_opt(jinit()),
                                        "step": jnp.zeros((), jnp.int32)}))
    return tp, jax.eval_shape(jinit)


def _meta(tree):
    return T.map_with_path(lambda _, t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree)


def _assert_bit_equal(got, want):
    g, w = T.stacked_leaves(got), T.stacked_leaves(want)
    assert [p for p, *_ in g] == [p for p, *_ in w]
    for (path, a, _), (_, b, _) in zip(g, w):
        a, b = torch.stack(a), torch.stack(b)
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _to_jax_layout(tree):
    return jax.tree.map(jnp.asarray, bridge.params_to_jax(tree))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", TREES)
def test_checkpoints_cross_between_packages(tmp_path, kind, direction):
    tp, abstract = _trees(kind)
    if direction == "jax_to_port":
        JCheckpointer(str(tmp_path)).save(_to_jax_layout(tp), step=3)
        got, step = Checkpointer(str(tmp_path)).restore(_meta(tp),
                                                        device="cpu")
        assert step == 3
        _assert_bit_equal(got, tp)
    else:
        Checkpointer(str(tmp_path)).save(tp, step=5)
        got, step = JCheckpointer(str(tmp_path)).restore(abstract)
        assert step == 5
        want = bridge.params_to_jax(tp)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save({"x": torch.ones((2,))}, step=s)
    assert ck.latest_step() == 3
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [2, 3]


def test_async_checkpoint_snapshots_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(8)
    ck.save_async({"x": x}, step=5)
    x.add_(100)  # the live tensor moves on; the snapshot does not
    ck.wait()
    restored, s = ck.restore({"x": torch.empty(8, dtype=torch.int64,
                                               device="meta")},
                             device="cpu")
    assert s == 5 and torch.equal(restored["x"], torch.arange(8))


def test_resume_or_init(tmp_path):
    ck = Checkpointer(str(tmp_path))
    template = {"x": torch.empty(3, device="meta")}
    tree, step = resume_or_init(ck, template,
                                lambda: {"x": torch.ones(3)},
                                log_fn=lambda *_: None, device="cpu")
    assert step == 0 and float(tree["x"][0]) == 1.0
    ck.save({"x": torch.full((3,), 5.0)}, step=9)
    tree, step = resume_or_init(ck, template,
                                lambda: {"x": torch.ones(3)},
                                log_fn=lambda *_: None, device="cpu")
    assert step == 9 and float(tree["x"][0]) == 5.0


def test_preemption_handler_runs_save():
    saved = []
    with PreemptionHandler(lambda: saved.append(1)) as ph:
        ph._handler(15, None)
        ph._handler(15, None)  # one emergency save only
    assert saved == [1] and ph.preempted


def test_straggler_monitor_flags_outliers():
    logs = []
    mon = StragglerMonitor(threshold=2.0, log_fn=logs.append)
    for _ in range(10):
        mon.record_step(0.1)
    mon.record_step(0.5)
    assert mon.slow_steps == 1 and logs
    assert mon.summary()["window"] == 11


def test_bfloat16_and_unreadable_leaves(tmp_path):
    """A bfloat16 leaf the JAX package saves (``ml_dtypes`` records)
    restores bit for bit, and the port's save of it writes the same
    records; a leaf numpy cannot read raises, naming the leaf."""
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(
        jnp.bfloat16)
    JCheckpointer(str(tmp_path / "j")).save({"a": {"w": x}}, step=1)
    got, _ = Checkpointer(str(tmp_path / "j")).restore(
        {"a": {"w": torch.empty(12, dtype=torch.bfloat16, device="meta")}},
        device="cpu")
    assert torch.equal(got["a"]["w"].view(torch.int16),
                       torch.from_numpy(np.asarray(x).view(np.int16)))
    Checkpointer(str(tmp_path / "t")).save(got, step=2)
    raw = np.load(tmp_path / "t" / "step_00000002" / "leaf_00000.npy")
    assert raw.tobytes() == np.asarray(x).tobytes()
    # a 3-byte record type: no dtype of numpy or torch reads it
    d = tmp_path / "j" / "step_00000001"
    np.save(d / "leaf_00000.npy", np.zeros((12,), "V3"))
    with pytest.raises(ValueError, match="a/w"):
        Checkpointer(str(tmp_path / "j")).restore(
            {"a": {"w": torch.empty(12, device="meta")}}, device="cpu")


def test_train_entry_point_resumes_after_relaunch(tmp_path, capsys,
                                                 monkeypatch):
    """``launch.train --smoke --device cpu``: 4 steps with a checkpoint
    every 2, then the identical command to 6 steps resumes at step 4 (the
    restored state equal to the saved one) and runs 2 more.  ``--mesh``
    outside a launcher of ranks (no ``RANK`` / ``WORLD_SIZE``) refuses to
    start."""
    from repro_torch.launch import train

    args = ["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = train.main(args + ["--steps", "4"])
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"] + first["grad_norms"]))
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    second = train.main(args + ["--steps", "6"])
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert int(second["state"]["step"]) == 6
    assert "[ft] restored checkpoint at step 4" in capsys.readouterr().out
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train.main(args + ["--mesh", "2x1"])


def test_serve_restores_a_params_only_checkpoint(tmp_path, capsys):
    """``serve.py --ckpt`` serves the checkpoint's params: its engine's
    greedy tokens equal an engine built on the same params directly, and
    the entry point runs end to end from it."""
    from repro_torch.launch import serve
    from repro_torch.quant.qlinear import cast_params
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = R.get_config("qwen2.5-1.5b", smoke=True)
    params = api.get_model(cfg).init_params(cfg, seed=11, device="cpu")
    Checkpointer(str(tmp_path)).save(params, step=6)
    argv = ["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
            "--ckpt", str(tmp_path), "--dry"]
    engine, tok = serve.build_engine(serve.parse_args(argv))
    direct = DecodeEngine(cast_params(params, torch.float32), cfg,
                          max_len=serve.MAX_LEN, eos_id=tok.eos_id,
                          pad_id=tok.pad_id)
    toks = torch.tensor([[5, 9, 40, 77, 3], [8, 8, 120, 3, 0]])
    lens = torch.tensor([5, 4])
    out = []
    for eng in (engine, direct):
        st = eng.prefill(toks, lens)
        out.append(eng.generate(st, 10, None, SamplerConfig(greedy=True),
                                stop_ids=(9999,))[1])
    assert torch.equal(out[0], out[1])
    rows = serve.main(argv + ["--continuous"])
    assert rows[0]["serving"]["completed_requests"] == 2


def test_serve_cache_capacity_bounds_the_prefix_cache(monkeypatch):
    """``--cache-capacity N`` reaches ``PrefixCache(capacity_blocks=N)``
    and the cache pins at most N blocks."""
    from repro_torch.launch import serve

    made = []
    orig = serve.PrefixCache

    def recording(pool, **kw):
        made.append(kw)
        return orig(pool, **kw)

    monkeypatch.setattr(serve, "PrefixCache", recording)
    rows = serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device",
                       "cpu", "--continuous", "--paged", "--kv-quant", "q8",
                       "--prefix-cache", "--fewshot", "3",
                       "--cache-capacity", "2", "--dry"])
    assert made == [{"capacity_blocks": 2}]
    assert rows[0]["serving"]["prefix_cache"]["cached_blocks"] <= 2
