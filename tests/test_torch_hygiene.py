"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
IMPORT = re.compile(r"^\s*(?:from\s+(\S+)\s+import|import\s+(.+))", re.M)


def _imported_modules(src: str):
    for m in IMPORT.finditer(src):
        names = m.group(1) or m.group(2)
        for name in names.split(","):
            yield name.strip().split(" ")[0]


def test_port_sources_import_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 10
    bad = []
    for path in PORT_FILES:
        for mod in _imported_modules(path.read_text()):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax") or \
                    re.match(r"\brepro\b(?!_torch)", mod):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, f"port files import JAX or the JAX package: {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT_FILES[:-1])
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_cpu(no_cuda):
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper

    cfg = get_config("qwen2.5-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params_from_jax({"embedding": {"table": np.zeros((4, 2))}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--continuous",
                    "--paged", "--dry"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        whisper.init_params(get_config("whisper-base", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen2.5-1.5b", "--smoke", "--steps", "1"])
    # asked for the CPU, they run there
    assert T.init_params(cfg, device="cpu")["embedding"]["table"].device \
        == torch.device("cpu")


def test_cpu_serve_entry_point_runs(no_cuda, capsys):
    from repro_torch.launch import serve

    rows = serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device",
                       "cpu", "--continuous", "--paged", "--kv-quant", "q4",
                       "--dry"])
    assert rows[0]["serving"]["completed_requests"] == 2
    assert "kv pool clean: 0 blocks" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
                    "--kv-quant", "q4", "--dry"])  # a quantized pool is paged


@pytest.mark.parametrize("draft", [["--self-draft"],
                                   ["--draft-model", "qwen2.5-1.5b"]])
def test_cpu_serve_speculative_entry_point_runs(no_cuda, capsys, draft):
    """``--spec-k`` serves greedy speculative rounds on the CPU when asked
    for it, prints its lines and drains the pool; without ``--device
    cpu`` it refuses, and it refuses flags that cannot work together."""
    from repro_torch.launch import serve

    args = ["--arch", "qwen2.5-1.5b", "--smoke", "--continuous", "--paged",
            "--kv-quant", "q8", "--spec-k", "4", *draft, "--dry"]
    rows = serve.main(args + ["--device", "cpu"])
    s = rows[0]["serving"]
    assert s["spec_rounds"] > 0 and s["completed_requests"] == 2
    out = capsys.readouterr().out
    assert "[serve] speculative decoding: k=4" in out
    assert "[serve] speculative: rounds=" in out
    assert "kv pool clean: 0 blocks" in out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(args)
    with pytest.raises(SystemExit, match="need --spec-k"):
        serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
                    "--continuous", "--paged", *draft, "--dry"])
    with pytest.raises(SystemExit, match="--continuous"):
        serve.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
                    "--paged", "--spec-k", "4", *draft, "--dry"])


def test_cpu_serve_writes_trace_and_profile_that_validate(no_cuda, capsys,
                                                          tmp_path):
    """``--trace`` / ``--profile`` on the CPU write a Chrome trace and a
    profile report that the port's validators (and CLIs) accept, print
    their lines, and are refused without ``--continuous``."""
    import json

    from repro_torch.launch import serve
    from repro_torch.serving import profiling, telemetry

    trace, report = tmp_path / "trace.json", tmp_path / "profile.json"
    args = ["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
            "--paged", "--kv-quant", "q8", "--dry", "--trace", str(trace),
            "--profile", str(report), "--canary-rate", "0.5"]
    rows = serve.main(args + ["--continuous"])
    s = rows[0]["serving"]
    assert s["latency_requests"] == 2 and s["ttft_p50"] > 0
    assert s["canary_samples"] > 0 and s["canary_argmax_flip_rate"] == 0.0
    out = capsys.readouterr().out
    assert "[serve] trace:" in out and "[serve] profile:" in out
    assert "[serve] latency: ttft_p50=" in out
    assert telemetry.validate_chrome_trace(json.loads(trace.read_text())) \
        == []
    assert profiling.validate_profile_report(
        json.loads(report.read_text())) == []
    assert telemetry.main([str(trace)]) == 0
    assert profiling.main([str(report)]) == 0
    with pytest.raises(SystemExit, match="--continuous"):
        serve.main(args)
