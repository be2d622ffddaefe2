"""Roofline-attributed kernel profiling and an online numerics-drift
canary (the JAX package's ``serving/profiling``, in eager PyTorch).

The tracer (:mod:`~repro_torch.serving.telemetry`) makes host-side
request life observable; this module adds the device-level half: where
does a decode step's time go, and are the paper's two approximations
(§5.1 tile quantization of the KV cache, §5.2 LUT softmax) still
numerically honest under real serving load?  Two halves, one recorder:

* **Roofline attribution.**  The kernel wrappers in
  :mod:`repro_torch.kernels.ops` (and the plain paged attention of
  ``layers.paged_decode_attention``) report every call to an installable
  hook with the analytic ``(flops, hbm_bytes)`` cost from the
  single-sourced models in :mod:`repro_torch.kernels.autotune`.  The
  engine brackets each prefill, decode step and speculative verify in a
  named **phase**.  PyTorch runs eagerly, so the hook fires on every
  dispatch: a phase accounts the ops that fired inside it, once each,
  and keeps no roster between calls (the JAX profiler caches the ops a
  jit traced and replays them on later calls).  Measured wall time is
  *sampled*: on sampled steps the phase end synchronizes the outputs'
  CUDA device (``torch.cuda.synchronize``, nothing on CPU tensors), so
  the wall covers the phase's device work, and the analytic roofline
  bound ``max(flops/PEAK, bytes/BW)`` divided by that wall is the
  phase's achieved-vs-peak efficiency.  On an eager step the wall also
  holds the host's dispatch of every op in the phase.  Per-kernel
  efficiency attributes each sampled phase wall across its ops in
  proportion to their analytic bounds.

* **Numerics-drift canary.**  On a configurable fraction of decode
  steps the engine first runs the live rows through the *exact* path —
  the ``"plain"`` paged-attention impl: table gather, the pool's plain
  dequant, f32 softmax — on the same planned state and token, then the
  production step, and the scheduler compares the two steps' logits: max
  logit error, argmax flip rate, plus the per-layer KV quant round-trip
  error (dequantize → re-quantize → dequantize) of the pool blocks the
  rows read.  Crossing a threshold records a warning.

**Clock semantics / zero overhead.**  Same contract as the tracer:
``clock`` is injectable (tests pass a deterministic counter), all times
are ``clock() - epoch`` seconds, and ``profiler=None`` everywhere means
no hook, no phases, no allocations — bit-identical scheduler outputs.

``launch/serve.py --profile report.json`` writes the JSON report
(schema ``repro.profile.v1``, the JAX package's); ``python -m
repro_torch.serving.profiling report.json`` validates it (see
:func:`validate_profile_report`).
"""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Callable

from repro_torch.kernels import autotune as _autotune
from repro_torch.serving.telemetry import percentile

SCHEMA = "repro.profile.v1"

# op name -> cost-breakdown category (unknown ops land in "other")
OP_CATEGORIES = {
    "flash_attention": "softmax",
    "paged_flash_decode": "softmax",
    "paged_attention_xla": "softmax",
    "lut_dequant_matmul": "dequant",
    "lut_dequant_kv": "dequant",
    "tile_quantize": "quantize",
}

# phase names the engine brackets its calls with; anything recorded
# outside an open phase lands in "untimed" (no wall attribution)
PHASE_NAMES = ("prefill", "decode", "spec_verify", "untimed")


# the profiler keys SchedulerMetrics.summary() reports; a scheduler with
# no profiler attached emits exactly these zeros, so the summary key set
# is identical with and without profiling (the null-parity contract)
NULL_PROFILE_METRICS = {
    "profiled_steps": 0,
    "kernel_time_share": 0.0,
    "roofline_efficiency_p50": 0.0,
    "canary_samples": 0,
    "canary_max_logit_err": 0.0,
    "canary_argmax_flip_rate": 0.0,
    "canary_kv_roundtrip_err": 0.0,
}


def _interval(rate: float) -> int:
    """Fraction -> deterministic every-Nth-step interval (0 disables)."""
    if rate <= 0.0:
        return 0
    return max(1, int(round(1.0 / min(rate, 1.0))))


def _sync(outputs) -> None:
    """Wait for the CUDA devices ``outputs`` (tensors, or nested tuples
    and lists of them) live on; CPU tensors need nothing.  Moves no
    tensor."""
    stack, devices = [outputs], set()
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif getattr(x, "is_cuda", False):
            devices.add(x.device)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class KernelProfiler:
    """Records per-kernel analytic cost, sampled measured wall time and
    canary drift gauges.  One instance per serving run; install on a
    scheduler via ``ContinuousScheduler(profiler=...)`` (which binds the
    engine slot and the ops dispatch hook).

    ``sample_rate`` is the fraction of scheduler steps whose phase walls
    are measured (a synchronize at the phase end — the only place the
    profiler ever syncs); ``canary_rate`` the fraction of steps re-run
    through the exact path.  Both are deterministic every-Nth-step
    schedules, so profiled runs are reproducible.
    """

    def __init__(self, *, sample_rate: float = 1.0,
                 canary_rate: float = 0.0,
                 clock: Callable[[], float] = time.perf_counter,
                 logit_err_warn: float = 0.05,
                 flip_rate_warn: float = 0.01,
                 kv_err_warn: float = 0.25):
        self.clock = clock
        self._t0 = clock()
        self.sample_rate = float(sample_rate)
        self.canary_rate = float(canary_rate)
        self.sample_interval = _interval(sample_rate)
        self.canary_interval = _interval(canary_rate)
        self.logit_err_warn = logit_err_warn
        self.flip_rate_warn = flip_rate_warn
        self.kv_err_warn = kv_err_warn
        # phase machinery: open phases (innermost last), each with the
        # ops that fired inside it during this call
        self._stack: list[str] = []
        self._calls: dict[str, list] = {}
        # accumulators
        self._ops: dict[str, dict] = {}        # per-kernel totals
        self._phases: dict[str, dict] = {}     # per-phase totals
        self._eff_samples: list[float] = []    # per sampled phase
        self._step_idx = 0
        self._sampled_steps = 0
        self._sample_this_step = True          # standalone phases sample
        self._step_wall = 0.0          # sampled phase walls, this step
        self._step_bound = 0.0
        self._step_walls: list[float] = []    # scheduler wall, sampled steps
        self._kernel_walls: list[float] = []  # phase-wall sums, same steps
        self.last_step_gauges: dict[str, float] = {}
        # canary
        self._canary_samples = 0
        self._canary_rows = 0
        self._canary_flips = 0
        self._canary_max_err = 0.0
        self._kv_err_per_layer: list[float] = []
        self.warnings: list[str] = []
        self._prev_hook = None
        self._installed = False

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the profiler's epoch."""
        return self.clock() - self._t0

    # -- ops dispatch hook ----------------------------------------------------
    def install(self) -> None:
        """Bind :meth:`record_op` as the kernels' dispatch hook."""
        from repro_torch.kernels import ops

        if not self._installed:
            self._prev_hook = ops.set_op_hook(self.record_op)
            self._installed = True

    def uninstall(self) -> None:
        """Restore the dispatch hook that was installed before us."""
        from repro_torch.kernels import ops

        if self._installed:
            ops.set_op_hook(self._prev_hook)
            self._installed = False

    def record_op(self, name: str, flops: float, hbm_bytes: float) -> None:
        """Dispatch-hook target: one kernel call's analytic cost, accounted
        at once and, inside an open phase, kept with the innermost phase's
        call for its wall attribution (an op outside every phase lands in
        ``untimed``)."""
        bound = self._account(name, float(flops), float(hbm_bytes))
        if self._stack:
            self._calls[self._stack[-1]].append((name, bound))
        else:
            ph = self._phases.setdefault(
                "untimed", {"calls": 0, "sampled": 0, "wall_s": 0.0,
                            "bound_s": 0.0})
            ph["bound_s"] += bound

    def _account(self, name: str, flops: float, hbm_bytes: float) -> float:
        op = self._ops.setdefault(
            name, {"calls": 0, "flops": 0.0, "hbm_bytes": 0.0,
                   "bound_s": 0.0, "wall_s": 0.0, "sampled_bound_s": 0.0})
        bound = _autotune.roofline_bound_s(flops, hbm_bytes)
        op["calls"] += 1
        op["flops"] += flops
        op["hbm_bytes"] += hbm_bytes
        op["bound_s"] += bound
        return bound

    # -- phases (the engine brackets its calls with these) -------------------
    def phase_begin(self, name: str) -> float:
        """Open phase ``name``; returns the t0 to pass to
        :meth:`phase_end`."""
        self._stack.append(name)
        self._calls[name] = []
        return self.now()

    def phase_end(self, name: str, t0: float, outputs=None) -> None:
        """Close phase ``name``: its bound is the sum over the ops that
        fired inside it.  On sampled steps, when ``outputs`` is given, it
        synchronizes the outputs' CUDA device and records the measured
        wall against that bound, attributed across the ops by bound
        share."""
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        calls = self._calls.pop(name, [])
        bound = sum(b for _, b in calls)
        ph = self._phases.setdefault(
            name, {"calls": 0, "sampled": 0, "wall_s": 0.0,
                   "bound_s": 0.0, "_effs": []})
        ph["calls"] += 1
        ph["bound_s"] += bound
        if not (self._sample_this_step and outputs is not None):
            return
        _sync(outputs)
        wall = self.now() - t0
        ph["sampled"] += 1
        ph["wall_s"] += wall
        self._step_wall += wall
        self._step_bound += bound
        if wall > 0.0 and bound > 0.0:
            eff = bound / wall
            ph.setdefault("_effs", []).append(eff)
            self._eff_samples.append(eff)
            for op_name, op_bound in calls:
                self._ops[op_name]["wall_s"] += wall * op_bound / bound
                self._ops[op_name]["sampled_bound_s"] += op_bound

    # -- per-scheduler-step sampling ------------------------------------------
    def begin_step(self) -> None:
        """Scheduler step start: decide whether this step's phases get
        measured walls and whether it is a canary step."""
        self._sample_this_step = (
            self.sample_interval > 0
            and self._step_idx % self.sample_interval == 0)
        self._step_wall = 0.0
        self._step_bound = 0.0

    def want_canary(self) -> bool:
        """True when the current step should re-run rows through the
        exact path (deterministic every-Nth-step schedule)."""
        return (self.canary_interval > 0
                and self._step_idx % self.canary_interval == 0)

    def end_step(self, wall_s: float) -> None:
        """Scheduler step end; ``wall_s`` is the scheduler's own step
        wall (tracer-clocked).  Exposes the step's kernel-time gauges in
        :attr:`last_step_gauges` for the tracer's counter tracks."""
        if self._sample_this_step:
            self._sampled_steps += 1
            self._step_walls.append(wall_s)
            self._kernel_walls.append(self._step_wall)
            self.last_step_gauges = {
                "kernel_time_s": self._step_wall,
                "roofline_bound_s": self._step_bound,
            }
        else:
            self.last_step_gauges = {}
        self._step_idx += 1
        self._sample_this_step = True  # standalone phases keep sampling

    # -- canary ----------------------------------------------------------------
    def record_canary(self, *, max_logit_err: float, flips: int, rows: int,
                      kv_err_per_layer=None) -> None:
        """One canary sample: ``rows`` live rows compared against the
        exact path, ``flips`` of them with a different argmax,
        ``max_logit_err`` the worst |logit delta| across them.
        ``kv_err_per_layer`` is the per-layer KV quant round-trip error
        (max |dequant(quant(dequant(pool))) - dequant(pool)|)."""
        self._canary_samples += 1
        self._canary_rows += int(rows)
        self._canary_flips += int(flips)
        self._canary_max_err = max(self._canary_max_err,
                                   float(max_logit_err))
        if kv_err_per_layer is not None:
            errs = [float(e) for e in kv_err_per_layer]
            if len(self._kv_err_per_layer) < len(errs):
                self._kv_err_per_layer += [0.0] * (
                    len(errs) - len(self._kv_err_per_layer))
            for i, e in enumerate(errs):
                self._kv_err_per_layer[i] = max(self._kv_err_per_layer[i],
                                                e)
            if errs and max(errs) > self.kv_err_warn:
                self._warn(f"kv round-trip error {max(errs):.4g} exceeds "
                           f"threshold {self.kv_err_warn:.4g} "
                           f"(layer {errs.index(max(errs))})")
        if float(max_logit_err) > self.logit_err_warn:
            self._warn(f"max logit error {float(max_logit_err):.4g} "
                       f"exceeds threshold {self.logit_err_warn:.4g} "
                       f"at step {self._step_idx}")
        rate = self._canary_flips / max(1, self._canary_rows)
        if rate > self.flip_rate_warn:
            self._warn(f"argmax flip rate {rate:.4g} exceeds threshold "
                       f"{self.flip_rate_warn:.4g} "
                       f"({self._canary_flips}/{self._canary_rows} rows)")

    def _warn(self, msg: str) -> None:
        if msg not in self.warnings:
            self.warnings.append(msg)

    # -- derivation ------------------------------------------------------------
    def summary_metrics(self) -> dict:
        """The profiler keys ``SchedulerMetrics.summary()`` merges in.
        Every key is 0.0-safe on an empty run."""
        step_wall = sum(self._step_walls)
        return {
            "profiled_steps": self._sampled_steps,
            "kernel_time_share": (sum(self._kernel_walls) / step_wall
                                  if step_wall > 0 else 0.0),
            "roofline_efficiency_p50": percentile(self._eff_samples, 50),
            "canary_samples": self._canary_samples,
            "canary_max_logit_err": self._canary_max_err,
            "canary_argmax_flip_rate": (
                self._canary_flips / self._canary_rows
                if self._canary_rows else 0.0),
            "canary_kv_roundtrip_err": (max(self._kv_err_per_layer)
                                        if self._kv_err_per_layer else 0.0),
        }

    def report(self) -> dict:
        """The full JSON-serializable profile report (``--profile``)."""
        kernels = {}
        for name, op in sorted(self._ops.items()):
            wall = op["wall_s"]
            kernels[name] = {
                "calls": op["calls"],
                "flops": op["flops"],
                "hbm_bytes": op["hbm_bytes"],
                "bound_s": op["bound_s"],
                "wall_s": wall,
                "category": OP_CATEGORIES.get(name, "other"),
                # achieved-vs-peak over *sampled* invocations only, so a
                # sub-1.0 sample rate doesn't skew the ratio
                "efficiency": (op["sampled_bound_s"] / wall
                               if wall > 0 else 0.0),
            }
        phases = {}
        for name, ph in sorted(self._phases.items()):
            phases[name] = {
                "calls": ph["calls"],
                "sampled": ph.get("sampled", 0),
                "wall_s": ph.get("wall_s", 0.0),
                "bound_s": ph["bound_s"],
                "efficiency_p50": percentile(ph.get("_effs", []), 50),
            }
        total_bound = sum(op["bound_s"] for op in self._ops.values())
        breakdown: dict[str, float] = {}
        for name, op in self._ops.items():
            cat = OP_CATEGORIES.get(name, "other")
            breakdown[cat] = breakdown.get(cat, 0.0) + (
                op["bound_s"] / total_bound if total_bound > 0 else 0.0)
        return {
            "schema": SCHEMA,
            "constants": {"peak_flops": _autotune.PEAK_FLOPS,
                          "hbm_bw": _autotune.HBM_BW},
            "sample_rate": self.sample_rate,
            "canary_rate": self.canary_rate,
            "steps": self._step_idx,
            "sampled_steps": self._sampled_steps,
            "kernels": kernels,
            "phases": phases,
            "breakdown": breakdown,
            "summary": self.summary_metrics(),
            "canary": {
                "samples": self._canary_samples,
                "rows": self._canary_rows,
                "flips": self._canary_flips,
                "max_logit_err": self._canary_max_err,
                "argmax_flip_rate": (
                    self._canary_flips / self._canary_rows
                    if self._canary_rows else 0.0),
                "kv_roundtrip_err_per_layer": list(self._kv_err_per_layer),
                "thresholds": {"logit_err": self.logit_err_warn,
                               "flip_rate": self.flip_rate_warn,
                               "kv_err": self.kv_err_warn},
                "warnings": list(self.warnings),
            },
        }

    def write_report(self, path: str) -> str:
        rep = self.report()
        bad = validate_profile_report(rep)
        if bad:  # never write a file the validator would reject
            raise ValueError(f"refusing to write invalid report: {bad[:3]}")
        with open(path, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# Report schema validation (the CI check)
# ---------------------------------------------------------------------------

_TOP_REQUIRED = ("schema", "steps", "sampled_steps", "kernels", "phases",
                 "breakdown", "summary", "canary")
_KERNEL_REQUIRED = ("calls", "flops", "hbm_bytes", "bound_s", "wall_s",
                    "efficiency")
_SUMMARY_REQUIRED = ("profiled_steps", "kernel_time_share",
                     "roofline_efficiency_p50", "canary_samples",
                     "canary_max_logit_err", "canary_argmax_flip_rate",
                     "canary_kv_roundtrip_err")
_CANARY_REQUIRED = ("samples", "rows", "flips", "max_logit_err",
                    "argmax_flip_rate", "kv_roundtrip_err_per_layer",
                    "warnings")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def validate_profile_report(obj) -> list[str]:
    """Structural validation of a ``repro.profile.v1`` report.  Returns
    violation strings (empty = valid):

    * top level: an object with ``schema == "repro.profile.v1"`` and all
      of ``steps/sampled_steps/kernels/phases/breakdown/summary/canary``;
    * every kernel entry carries finite, non-negative
      ``calls/flops/hbm_bytes/bound_s/wall_s/efficiency``;
    * breakdown shares are in [0, 1] and sum to at most 1 (+eps);
    * the summary carries every key the scheduler merges (all finite);
    * the canary block is complete, its per-layer errors numeric and its
      warnings strings.
    """
    bad: list[str] = []
    if not isinstance(obj, dict):
        return ["top level must be an object"]
    if obj.get("schema") != SCHEMA:
        bad.append(f"schema must be {SCHEMA!r} (got {obj.get('schema')!r})")
    missing = [k for k in _TOP_REQUIRED if k not in obj]
    if missing:
        bad.append(f"missing top-level keys {missing}")
        return bad
    if not _num(obj["steps"]) or obj["steps"] < 0:
        bad.append(f"steps: bad value {obj['steps']!r}")
    if not _num(obj["sampled_steps"]) or obj["sampled_steps"] < 0:
        bad.append(f"sampled_steps: bad value {obj['sampled_steps']!r}")
    if not isinstance(obj["kernels"], dict):
        bad.append("kernels must be an object")
    else:
        for name, op in obj["kernels"].items():
            if not isinstance(op, dict):
                bad.append(f"kernel {name}: not an object")
                continue
            for k in _KERNEL_REQUIRED:
                v = op.get(k)
                if not _num(v) or v < 0:
                    bad.append(f"kernel {name}: bad {k} {v!r}")
    if not isinstance(obj["phases"], dict):
        bad.append("phases must be an object")
    if not isinstance(obj["breakdown"], dict):
        bad.append("breakdown must be an object")
    else:
        total = 0.0
        for cat, share in obj["breakdown"].items():
            if not _num(share) or not (0.0 <= share <= 1.0 + 1e-6):
                bad.append(f"breakdown {cat}: bad share {share!r}")
            else:
                total += share
        if total > 1.0 + 1e-6:
            bad.append(f"breakdown shares sum to {total} > 1")
    summary = obj["summary"]
    if not isinstance(summary, dict):
        bad.append("summary must be an object")
    else:
        for k in _SUMMARY_REQUIRED:
            if not _num(summary.get(k)):
                bad.append(f"summary: bad {k} {summary.get(k)!r}")
    canary = obj["canary"]
    if not isinstance(canary, dict):
        bad.append("canary must be an object")
    else:
        for k in _CANARY_REQUIRED:
            if k not in canary:
                bad.append(f"canary: missing {k}")
        for k in ("samples", "rows", "flips", "max_logit_err",
                  "argmax_flip_rate"):
            if k in canary and not _num(canary[k]):
                bad.append(f"canary: bad {k} {canary[k]!r}")
        errs = canary.get("kv_roundtrip_err_per_layer", [])
        if not isinstance(errs, list) or not all(_num(e) for e in errs):
            bad.append("canary: kv_roundtrip_err_per_layer must be a "
                       "list of finite numbers")
        warns = canary.get("warnings", [])
        if not isinstance(warns, list) or not all(
                isinstance(w, str) for w in warns):
            bad.append("canary: warnings must be a list of strings")
    return bad


def main(argv=None) -> int:
    """``python -m repro_torch.serving.profiling report.json [...]`` — validate
    profile reports; exits non-zero listing the violations."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.serving.profiling REPORT.json [...]",
              file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            rc = 1
            continue
        bad = validate_profile_report(obj)
        if bad:
            for msg in bad:
                print(f"{path}: {msg}", file=sys.stderr)
            rc = 1
        else:
            s = obj["summary"]
            print(f"{path}: OK ({len(obj['kernels'])} kernels, "
                  f"{obj['sampled_steps']}/{obj['steps']} steps sampled, "
                  f"eff_p50={s['roofline_efficiency_p50']:.3g}, "
                  f"flip_rate={s['canary_argmax_flip_rate']:.3g})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
