"""The decode forward replayed from one CUDA graph, on the CPU.

``DecodeGraph``'s two CUDA calls (capture and replay) are stood in for by
:class:`FakeGraph`, which records each call and replays by running the
captured forward eagerly into the same output buffer; everything around
them is the engine's own: which steps replay and which run eager, the
single capture, the launch counters a replay adds, the ``forward``
span's ``graph`` arg and the ``capture`` span.  The graph on the card is
held to the eager forward in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR
from repro_torch.quant.qlinear import quantize_model_params
from repro_torch.serving import engine as E
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.profiling import KernelProfiler
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.telemetry import Tracer, validate_chrome_trace

# W4A16-tileable: every projection goes through K3's wrapper
CFG = ModelConfig(name="graph", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
                  dtype="float32", qkv_bias=True, tie_embeddings=True)
SLOTS = 6
MAX_LEN = 64
BS = 8


class FakeGraph(DecodeGraph):
    """The CUDA calls stood in for: a capture runs the forward once (as a
    capture's Python pass does, counting the wrappers' launches, its
    writes landing in the scratch block) and keeps it; a replay runs it
    again into the captured output buffer, its own counted launches taken
    back (a replay calls no wrapper)."""

    made: list = []

    @staticmethod
    def available(device) -> bool:
        return True

    def _record(self, fn):
        FakeGraph.made.append(self)
        self.recorded = fn
        return fn()

    def _replay(self):
        before = ops.launch_tally()
        self.out.copy_(self.recorded())
        ops.add_launches(ops.tally_delta(before, ops.launch_tally()),
                         times=-1)


@pytest.fixture
def fake(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(E, "DecodeGraph", FakeGraph)
    return FakeGraph


@pytest.fixture
def counted(monkeypatch):
    """The plain versions count as the kernels do (K3 by shape too), so
    the CPU run's counters stand in for the card's."""
    plain_gemm, plain_pa = G.plain_lut_dequant_gemm, PA._plain

    def gemm(x, codes, *a, **kw):
        G.lut_dequant_gemm.launches += 1
        G.lut_dequant_gemm.shapes[x.shape[0], x.shape[1],
                                  codes.shape[1] * 2] += 1
        return plain_gemm(x, codes, *a, **kw)

    def pa(q, k_pool, *a, **kw):
        w = PA.quant_paged_attention if isinstance(k_pool, dict) \
            else PA.paged_attention
        w.launches += 1
        return plain_pa(q, k_pool, *a, **kw)

    monkeypatch.setattr(G, "plain_lut_dequant_gemm", gemm)
    monkeypatch.setattr(PA, "_plain", pa)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.fixture(scope="module")
def params():
    return quantize_model_params(TR.init_params(CFG, seed=5, device="cpu"))


def _engine(params, kv="q8", paged=True):
    if not paged:
        return E.DecodeEngine(params, CFG, max_len=MAX_LEN)
    return E.DecodeEngine(params, CFG, max_len=MAX_LEN, paged=True,
                          block_size=BS,
                          n_blocks=1 + 2 * SLOTS * (MAX_LEN // BS),
                          kv_quant=kv)


def _prompts(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(3, 500, (int(k),), generator=gen,
                          dtype=torch.int32)
            for k in torch.randint(4, 20, (n,), generator=gen)]


def _state(eng, batch):
    ps = _prompts(batch)
    toks = torch.zeros((batch, 20), dtype=torch.int32)
    for i, p in enumerate(ps):
        toks[i, :len(p)] = p
    return eng.prefill(toks, torch.tensor([len(p) for p in ps],
                                          dtype=torch.int32))


def _graph_flags(tr):
    return [sp.args["graph"] for sp in tr.spans if sp.name == "forward"]


def _steps(eng, st, n, gen, **kw):
    for _ in range(n):
        st, _ = eng.step(st, gen, SamplerConfig(temperature=0.8), **kw)
    return st


# ---------------------------------------------------------------------------
# when the forward replays and when it runs eager
# ---------------------------------------------------------------------------

def test_replays_at_the_captured_width_only(params, fake):
    """The first offered step runs eager, the second captures, every
    later one at that width replays; another width runs eager and never
    captures again."""
    eng = _engine(params)
    eng.tracer = tr = Tracer()
    gen = torch.Generator().manual_seed(0)
    st = _steps(eng, _state(eng, SLOTS), 4, gen, graph=True)
    assert _graph_flags(tr) == [False, True, True, True]
    assert len(fake.made) == 1 and fake.made[0].replays == 3
    narrow = _steps(eng, _state(eng, SLOTS - 2), 3, gen, graph=True)
    assert _graph_flags(tr)[4:] == [False] * 3
    assert len(fake.made) == 1 and fake.made[0].replays == 3
    _steps(eng, st, 1, gen, graph=True)
    assert _graph_flags(tr)[-1] is True and fake.made[0].replays == 4
    eng.release_rows(narrow, range(SLOTS - 2))


@pytest.mark.parametrize("case", ["not_offered", "plain_impl", "op_hook",
                                  "pool_moved", "generate", "self_draft",
                                  "canary"])
def test_eager_callers(params, fake, case):
    """After the capture, a step that is not the captured one runs eager:
    a caller that does not offer the graph (the direct path), the plain
    paged-attention impl, an installed op hook, a pool whose leaves moved,
    ``generate``, a self-draft step (``trace_core=False``) and the
    canary's exact replica."""
    eng = _engine(params)
    eng.tracer = tr = Tracer()
    gen = torch.Generator().manual_seed(0)
    st = _steps(eng, _state(eng, SLOTS), 2, gen, graph=True)
    g = fake.made[0]
    assert g.replays == 1
    n_fwd = len(_graph_flags(tr))
    if case == "not_offered":
        _steps(eng, st, 2, gen)
    elif case == "plain_impl":
        prev = L.set_paged_attention_impl(L.PLAIN_IMPL)
        try:
            _steps(eng, st, 2, gen, graph=True)
        finally:
            L.set_paged_attention_impl(prev)
    elif case == "op_hook":
        calls = []
        prev = ops.set_op_hook(lambda *a: calls.append(a[0]))
        try:
            _steps(eng, st, 2, gen, graph=True)
        finally:
            ops.set_op_hook(prev)
        assert "paged_flash_decode" in calls
    elif case == "pool_moved":
        eng.pool.k = {k: v.clone() for k, v in eng.pool.k.items()}
        _steps(eng, st, 2, gen, graph=True)
    elif case == "generate":
        eng.generate(st, 3, gen, SamplerConfig(temperature=0.8))
    elif case == "self_draft":
        # as ContinuousScheduler._draft_proposals_self calls it
        _steps(eng, st, 2, gen, trace_core=False)
    elif case == "canary":
        st, _ = eng.step(st, gen, SamplerConfig(temperature=0.8),
                         canary=True, graph=True)
        # the production step replays; its exact replica ran eager
        assert g.replays == 2
        assert eng.last_canary_logits is not None
        return
    assert g.replays == 1 and len(fake.made) == 1
    assert not any(_graph_flags(tr)[n_fwd:])


def test_plain_impl_never_captures(params, fake):
    """Under the plain paged attention (no kernel) offered steps run
    eager and capture nothing."""
    eng = _engine(params)
    prev = L.set_paged_attention_impl(L.PLAIN_IMPL)
    try:
        _steps(eng, _state(eng, SLOTS), 3, torch.Generator().manual_seed(0),
               graph=True)
    finally:
        L.set_paged_attention_impl(prev)
    assert fake.made == [] and eng._graph is None


def test_cpu_tensors_run_eager(params):
    """Without a stand-in, a CPU engine never captures."""
    eng = _engine(params)
    eng.tracer = tr = Tracer()
    _steps(eng, _state(eng, SLOTS), 4, torch.Generator().manual_seed(0),
           graph=True)
    assert eng._graph is None
    assert _graph_flags(tr) == [False] * 4
    assert not [sp for sp in tr.spans if sp.name == "capture"]


def test_dense_engine_and_profiler_run_eager(params, fake):
    """A dense engine never captures, nor does a scheduler whose profiler
    installed its op hook."""
    for eng, prof in ((_engine(params, paged=False), None),
                      (_engine(params), KernelProfiler(sample_rate=1.0))):
        sched = E.ContinuousScheduler(eng, n_slots=SLOTS, prompt_len=20,
                                      stop_ids=(9999,), profiler=prof)
        for i, p in enumerate(_prompts(3)):
            sched.submit(E.Request(req_id=i, prompt=p, max_new_tokens=6,
                                   n_samples=2))
        try:
            sched.run(torch.Generator().manual_seed(0),
                      SamplerConfig(temperature=0.8))
        finally:
            if prof is not None:
                prof.uninstall()
        assert eng._graph is None
    assert fake.made == []


# ---------------------------------------------------------------------------
# the scheduler: one capture, the same tokens, the same launch counts
# ---------------------------------------------------------------------------

def _serve(params, kv, spec=None, greedy=False):
    eng = _engine(params, kv)
    tr = Tracer()
    sched = E.ContinuousScheduler(eng, n_slots=SLOTS, prompt_len=20,
                                  stop_ids=(7,), tracer=tr, spec=spec)
    for i, p in enumerate(_prompts(9, seed=1)):
        sched.submit(E.Request(req_id=i, prompt=p,
                               max_new_tokens=5 + 3 * (i % 4),
                               n_samples=3 if i % 3 == 0 else 1))
    sc = SamplerConfig(greedy=True) if greedy else \
        SamplerConfig(temperature=0.8)
    out = sched.run(torch.Generator().manual_seed(2), sc)
    return out, ops.launch_counts(), ops.gemm_launches_by_shape(), tr, \
        sched, eng


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
def test_one_capture_over_many_steps(params, counted, monkeypatch, kv):
    """Best-of-3 groups and plain requests of mixed lengths, admitted and
    released over many steps: one capture in the run, every step after it
    replayed, tokens, pool and launch counters as the eager run's."""
    want, counts0, shapes0, _, _, eng0 = _serve(params, kv)
    pool0 = [t.clone() for t in ops_leaves(eng0.pool)]
    ops.reset_launch_counts()
    FakeGraph.made = []
    monkeypatch.setattr(E, "DecodeGraph", FakeGraph)
    got, counts1, shapes1, tr, sched, eng1 = _serve(params, kv)
    assert got == want
    assert all(torch.equal(a, b)
               for a, b in zip(pool0, ops_leaves(eng1.pool)))
    assert counts1 == counts0 and shapes1 == shapes0
    assert len(FakeGraph.made) == 1
    flags = _graph_flags(tr)
    assert flags[:2] == [False, True] and all(flags[1:])
    assert FakeGraph.made[0].replays == len(flags) - 1 \
        == sched.step_count - 1
    assert eng1.pool.blocks_in_use == 0


def ops_leaves(pool):
    out = []
    for leaf in (pool.k, pool.v):
        out.extend(leaf.values() if isinstance(leaf, dict) else [leaf])
    return out


def test_self_draft_rounds_run_eager(params, fake):
    """Speculative self-drafting: every step of this run is a round (its
    snapshot steps at the slots' width, then a verify), none offered the
    graph, so nothing is captured; tokens equal the eager run's."""
    spec = E.SpecConfig(k=3, self_draft=True)
    want = _serve(params, "q8", spec=spec, greedy=True)[0]
    got, _, _, tr, sched, _ = _serve(params, "q8", spec=spec, greedy=True)
    assert got == want
    assert sched.metrics.spec_rounds == sched.step_count > 0
    assert fake.made == [] and _graph_flags(tr) == []


def test_replay_adds_the_captured_launch_delta(params, fake, counted):
    """The capture's counted launches are taken back and each replay adds
    them: one K2 launch per layer and six K3 launches per layer at M =
    the batch width, every step alike, eager or replayed."""
    eng = _engine(params)
    st = _state(eng, SLOTS)
    gen = torch.Generator().manual_seed(0)
    per_step = []
    for _ in range(5):
        before = ops.launch_tally()
        st, _ = eng.step(st, gen, SamplerConfig(temperature=0.8), graph=True)
        per_step.append(ops.tally_delta(before, ops.launch_tally()))
    g = fake.made[0]
    assert g.replays == 4
    assert all(d == per_step[0] for d in per_step)
    assert g.launches == per_step[0]
    assert g.launches["quant_paged_attention"] == CFG.n_layers
    assert g.launches["lut_dequant_gemm"] == 6 * CFG.n_layers
    assert sum(n for k, n in g.launches.items()
               if isinstance(k, tuple)) == 6 * CFG.n_layers
    assert all(k[1][0] == SLOTS for k in g.launches if isinstance(k, tuple))


def test_launch_tally_round_trip(counted):
    """``add_launches`` undoes and redoes a ``tally_delta``."""
    before = ops.launch_tally()
    G.lut_dequant_gemm.launches += 3
    G.lut_dequant_gemm.shapes[4, 64, 128] += 3
    PA.quant_paged_attention.launches += 2
    d = ops.tally_delta(before, ops.launch_tally())
    assert d == {"lut_dequant_gemm": 3, "quant_paged_attention": 2,
                 ("lut_dequant_gemm", (4, 64, 128)): 3}
    ops.add_launches(d, times=-1)
    assert ops.tally_delta(before, ops.launch_tally()) == {}
    ops.add_launches(d, times=2)
    assert ops.launch_counts()["quant_paged_attention"] == \
        before["quant_paged_attention"] + 4


def test_held_pending_logits_survive_the_next_replay(params, fake):
    """A step's pending logits are a fresh tensor, not the graph's output
    buffer: the next replay leaves a held state's logits unchanged."""
    eng = _engine(params)
    gen = torch.Generator().manual_seed(0)
    st = _steps(eng, _state(eng, SLOTS), 2, gen, graph=True)
    held = st.pending_logits
    copy = held.clone()
    assert held.data_ptr() != fake.made[0].out.data_ptr()
    st2 = _steps(eng, st, 1, gen, graph=True)
    assert fake.made[0].replays == 2
    assert torch.equal(held, copy)
    assert not torch.equal(st2.pending_logits, copy)


def test_captured_engine_is_freed_by_reference_counts(params, monkeypatch):
    """The graph keeps no reference to the forward it captured, so an
    engine and its graph form no cycle: dropping the engine frees its
    pool at once, without the cycle collector."""
    import gc
    import weakref

    class Kept(FakeGraph):
        def _record(self, fn):      # as the card's: fn is not kept
            return fn()

        def _replay(self):
            pass

    monkeypatch.setattr(E, "DecodeGraph", Kept)
    eng = _engine(params)
    gen = torch.Generator().manual_seed(0)
    st = _steps(eng, _state(eng, SLOTS), 2, gen, graph=True)
    assert eng._graph is not None
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng, st
        assert gone() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------

def test_capture_and_forward_spans(params, fake):
    """One ``capture`` span with the batch and table width, inside the
    ``forward`` span of the step that captured (the first with
    ``graph=True``); the trace validates."""
    _, _, _, tr, sched, eng = _serve(params, "q8")
    caps = [sp for sp in tr.spans if sp.name == "capture"]
    assert len(caps) == 1
    assert caps[0].args == {"batch": SLOTS, "width": eng.table_width}
    fwd = [sp for sp in tr.spans if sp.name == "forward"]
    owner = [sp for sp in fwd
             if sp.t0 <= caps[0].t0 and caps[0].t1 <= sp.t1]
    assert len(owner) == 1 and owner[0].args["graph"] is True
    assert fwd.index(owner[0]) == 1
    assert all(isinstance(sp.args["graph"], bool) for sp in fwd)
    assert validate_chrome_trace(tr.to_chrome_trace()) == []
    assert sched.metrics.summary()["completed_requests"] == 9
    assert np.all(np.asarray([sp.t1 >= sp.t0 for sp in tr.spans]))
