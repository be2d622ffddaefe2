"""The dense family is the harness's former dense path, moved: its
weights are the same to the bit, and the readers that now take its cost
rules read what they read before.  The checksums and readings were
recorded from the harness before the move (``benchlib/weights.make`` and
``split_layers``; the readers over ``yardstick``'s FLOP rules)."""
import hashlib
import json
from pathlib import Path

import pytest

from tiny import CONFIG, WIDE

from benchlib import bench, spec
from benchlib.devtrace import DeviceTrace

ROOT = Path(__file__).resolve().parents[1]
F = spec.family_module("transformer")

WEIGHTS_SHA256 = {
    ("tiny", 3):
        "40db9eba65d73b3f3ae15ac1fb10a4c26e84f0b6cc4d5abbebd3a0bd1f9e619d",
    ("tiny", 2 ** 31 + 12345):
        "e39fecd24a1f71bfc8fea700dc70fd6811f9545bbf868a7050723eaa8cbe58ab",
    ("wide", 3):
        "075879f321e9502c82257de06d9dec03d7cb5f2790e5d41205255ae78c684d12",
    ("wide", 2 ** 31 + 12345):
        "efc0b17ea59306bfef903844fa380ae85f64efc9b8aafcea403fe85f494c5d96",
}
READINGS = {"step_mfu": 0.05671027032577553,
            "k2_roofline": 0.2480036298507463,
            "k3_roofline": 0.001495613134328358}


def _flat(node, path):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flat(node[k], f"{path}/{k}")
    else:
        yield path, node


def _digest(top, layers) -> str:
    """Every leaf's path, dtype, shape and bytes, in path order."""
    h = hashlib.sha256()
    items = list(_flat(top, "top"))
    for i, lay in enumerate(layers):
        items += list(_flat(lay, f"layers/{i}"))
    for path, t in items:
        t = t.contiguous()
        h.update(f"{path} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(WEIGHTS_SHA256))
def test_dense_weights_are_the_same_bits(name, seed):
    config = {"tiny": CONFIG, "wide": WIDE}[name]
    top, layers = F.make_weights(F.dims(config), seed, "cpu")
    assert _digest(top, layers) == WEIGHTS_SHA256[name, seed]


def _rec() -> dict:
    """A fixed traced window of the qwen2.5-1.5b cells' shape: 5 steps of
    64 rows, five admission prefills, 28 K2 launches a step."""
    qwen = json.loads((ROOT / "configs" / "qwen2.5-1.5b-w4a16.json")
                      .read_text())
    steps = 5
    contexts = [[97 + 13 * i + s for i in range(48)]
                + [1100 + 3 * i + s for i in range(16)] for s in range(steps)]
    ops = [("void paged_attention_kernel<128, 8>(int, float*)", 0.0, 0.0021),
           ("void fold_kernel<128>(float*)", 0.0021, 0.0004),
           ("void tile_gemm_kernel<4>(half*)", 0.003, 0.05)] * (steps * 28)
    dev = DeviceTrace(host_t0=10.0, host_t1=16.25, ops=ops,
                      k2_launches=28 * steps,
                      k3_shapes={(64, 1536, 1536): 56,
                                 (64, 1536, 8960): 28})
    return {"model": F.dims(qwen), "family": F, "n_slots": 64,
            "device": dev,
            "work": {"contexts": contexts,
                     "prefills": [(1100, 896), (150, 0), (256, 0),
                                  (1152, 896), (48, 0)]},
            "max_len": 1680, "block_size": 16,
            "k2_symbols": bench.K2_SYMBOLS, "k3_symbols": bench.K3_SYMBOLS}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_read_as_before(name):
    assert spec.metric_reader(name).read(_rec()) == READINGS[name]
