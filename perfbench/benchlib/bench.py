"""One run of one cell: set-up, the measured window, the traced reading,
then the comparison that decides ``correct``."""
from __future__ import annotations

import gc
import sys
import time

import torch

from benchlib import devtrace as DT
from benchlib import judge as J
from benchlib import loop as LP
from benchlib import spec as SP
from benchlib import stats as ST
from benchlib import traffic as TR

GIB = 2 ** 30
# kernel symbols, as the port's CUDA sources name them
K3_SYMBOLS = r"\b(tc|tile|fma)_gemm_kernel\b"
K2_SYMBOLS = r"\b(paged_attention_kernel|fold_kernel)\b"
# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the numbers that decide ``correct``, each held to the cell's limit
COMPARED = ("gap_max", "gap_mean")
# a traced run profiles the device over the window's last seconds: tens
# of steps, a few hundred thousand device activities to read
TRACE_SECONDS = 6.0


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())


def work(loop: LP.ClosedLoop, sched, step0: int, step1: int,
         mix: dict) -> dict:
    """The model's work in steps [step0, step1): each step's live decode
    rows by context length, and each admission prefill's (prompt,
    cached) lengths."""
    contexts = {s: [] for s in range(step0, step1)}
    prefills = []
    partial = {rid: {c.sample_idx: c for c in got}
               for rid, got in sched.completed.items()}
    for run in loop.runs.values():
        a = loop.admitted.get(run.task.index)
        if a is None:
            continue
        P = len(run.task.prompt)
        if step0 <= a < step1:
            prefills.append((P, TR.cached_tokens(run.task, mix)))
        for i in range(loop.n):
            if i in run.samples:
                last = run.samples[i][4]
            elif i in partial.get(run.task.index, {}):
                last = partial[run.task.index][i].finished_step
            else:
                last = step1 - 1
            for s in range(max(a, step0), min(last, step1 - 1) + 1):
                contexts[s].append(P + (s - a) + 1)
    return {"contexts": [contexts[s] for s in range(step0, step1)],
            "prefills": prefills}


def run(cell: SP.Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float, cfg=None, control: bool = False,
        faults=None, clock=time.perf_counter) -> dict:
    """One run; returns the result line's dict, ``checks`` last.
    ``t_start`` is the process's start on ``clock``; ``cfg`` stands in for
    the port's configuration and ``faults(engine)`` breaks the timed path
    (the tests' tiny cells); with ``control`` the control's tokens are
    judged in place of the served ones (``control.py``)."""
    from repro_torch.serving.telemetry import Tracer

    config, mix = cell.config, cell.traffic
    model = cell.family.dims(config)
    marks = [("imports", clock())]
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build

        build.build_all()
    marks.append(("kernels", clock()))
    tracer = Tracer(clock) if trace else None
    sched, engine = LP.build(config, mix, seed, device,
                             family=cell.family, cfg=cfg, tracer=tracer)
    marks.append(("engine", clock()))
    if faults is not None:
        faults(engine)
    stream = TR.TaskStream(mix, seed, model["vocab_size"])
    loop = LP.ClosedLoop(sched, stream, mix["n_samples"],
                         mix["temperature"], seed, clock=clock)
    loop.start(int(mix["clients"]))
    prof = DT.Profiler() if trace and torch.device(device).type == "cuda" \
        else None
    if prof is not None:
        prof.warm()
    trace_s = min(TRACE_SECONDS, seconds / 2)

    def on_step(lp, t0):
        if prof is not None and prof.prof is None and \
                lp.clock() - t0 >= seconds - trace_s:
            prof.start(lp.clock, lp.sched.step_count)

    t_w0, win = LP.run_window(loop, seconds, on_step)
    setup_s = t_w0 - t_start
    marks.append(("warm-up", t_w0))
    print("perfbench: set-up s: " + ", ".join(
        f"{name} {t - t0:.3f}" for (_, t0), (name, t) in
        zip([("", t_start)] + marks, marks)), file=sys.stderr)
    dtrace = prof.stop(loop.clock, sched.step_count) if prof else None
    if dtrace is not None:
        print(f"perfbench: traced steps {dtrace.step0}-{dtrace.step1} over "
              f"{dtrace.window_s:.3f} s (profiler start "
              f"{dtrace.start_s:.3f} s), {len(dtrace.ops)} device ops, "
              f"{sum(dtrace.k3_shapes.values())} K3 and "
              f"{dtrace.k2_launches} K2 launches", file=sys.stderr)
    peak = _peak_bytes(device)
    pool = engine.pool.stats()
    print(f"perfbench: KV pool peak in use {pool['peak_bytes_in_use']} B "
          f"({pool['peak_blocks_in_use']} blocks) of "
          f"{pool['pool_reserved_bytes']} B reserved", file=sys.stderr)
    n_slots = sched.n_slots
    lat = ST.task_latencies(win.done, win.open_ages)
    metrics: dict = {}
    breakdown = None
    if not trace:
        vals = {"decode_tok_per_s": ST.window_rate(win.steps, win.t0,
                                                   win.t1),
                "task_p90_s": ST.percentile(lat, 90),
                "peak_device_gib": peak / GIB,
                "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        # the tracer's clock counts from its own start
        base = tracer.clock() - tracer.now()
        rec = {"model": model, "family": cell.family, "n_slots": n_slots,
               "steps": win.steps, "done": win.done,
               "spans": tracer.spans,
               "span_window": (win.t0 - base, win.t1 - base), "prefix_cache":
               bool(mix.get("prefix_cache")),
               "block_size": LP.BLOCK_SIZE, "max_len": engine.max_len,
               "saved_in_window": sched.metrics.prefill_tokens_saved
               - win.saved0,
               "admitted_prompt_tokens": sum(
                   len(r.task.prompt) for r in loop.runs.values()
                   if loop.admitted.get(r.task.index, -1) >= win.step0),
               "device": dtrace, "work": None,
               "k3_symbols": K3_SYMBOLS, "k2_symbols": K2_SYMBOLS}
        if dtrace is not None:
            rec["work"] = work(loop, sched, dtrace.step0, dtrace.step1,
                               mix)
        for m in cell.per_layer:
            v = SP.metric_reader(m["name"], cell.root).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace is not None:
            off = dtrace.host_t0 - dtrace.unix_t0
            first = dtrace.ops[0][1] + off if dtrace.ops else dtrace.host_t0
            if not dtrace.host_t0 - 1.0 <= first <= dtrace.host_t1 + 1.0:
                off = dtrace.host_t0 - dtrace.ops[0][1]
            breakdown = {
                "device_ops": DT.top_ops(dtrace.ops),
                "idle_gaps": DT.idle_gaps(dtrace.ops, tracer.spans,
                                          lambda t: t + off - base)}
    judged = J.choose(win.done, loop.rows, mix, seed,
                      int(cell.limits["judge_tasks"]))
    states, temperature = loop.gen_states, float(mix["temperature"])
    attempted = len(win.done) + len(win.open_ages)
    # the program's state goes before the reference runs; the window's
    # frozen generation holds its cycles (the pool and the prefix cache)
    del sched, engine
    loop.sched = None
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        print(f"perfbench: {torch.cuda.memory_allocated()} B left "
              f"allocated for the reference", file=sys.stderr)
    checks = reference_checks(cell, model, seed, judged, states, n_slots,
                              temperature, device, control)
    lim = cell.limits
    compared = {name: {"value": checks[name], "limit": lim[name]["limit"]}
                for name in COMPARED}
    compared["judged_tokens"] = {"value": checks["judged_tokens"],
                                 "limit": lim["judged_tokens_min"]}
    correct = all(c["value"] <= c["limit"] for n, c in compared.items()
                  if n in COMPARED) and \
        checks["judged_tokens"] >= lim["judged_tokens_min"]
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if dtrace is not None:
        dev["busy_s"] = DT.busy_s(dtrace.ops)
        dev["window_s"] = dtrace.window_s
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out


def reference_checks(cell, model, seed, judged, states, n_slots,
                     temperature, device, control: bool) -> dict:
    """The family's weights made again from the seed, a layer at a time,
    the reference over the judged sequences, float32 with TF32 off."""
    ref = SP.reference_module(cell.config["reference"], cell.root)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            w = ref.prepare(*cell.family.make_weights(model, seed, device))
            return J.gaps(ref, w, model, judged, states, n_slots,
                          temperature, device,
                          control=(ref.BELOW[cell.config["torch_dtype"]]
                                   if control else None))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
