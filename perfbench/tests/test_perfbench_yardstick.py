"""The yardstick's frozen cost rules equal the port's
``kernels/autotune`` at the cells' shapes today; a change to either
shows here.  The dense family's FLOPs of a token."""
import pytest

import tiny  # noqa: F401

from benchlib import spec
from benchlib import yardstick as Y

SHAPES = [(M, K, N) for M in (1, 48, 257, 1024, 1152)
          for K, N in ((1536, 1536), (1536, 256), (1536, 8960))]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_gemm_cost_is_the_ports(M, K, N):
    from repro_torch.kernels import autotune

    assert Y.gemm_cost(M, K, N) == autotune.gemm_cost(M, K, N)


@pytest.mark.parametrize("B,W,tokens", [(1024, 49, 1024 * 300),
                                        (256, 105, 256 * 1100),
                                        (256, 105, None)])
def test_paged_attn_cost_is_the_ports(B, W, tokens):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune, ops
    from repro_torch.serving.kv_quant import QuantKVPool

    cfg = get_config("qwen2.5-1.5b")
    pool = QuantKVPool(cfg.with_(n_layers=1), 2, 16, mode="q8",
                       device="cpu")
    slab = ops.pool_slab_bytes({k: v[0] for k, v in pool.k.items()})
    assert slab == Y.q8_slab_bytes(cfg.n_kv_heads, cfg.head_dim)
    assert Y.paged_attn_cost(B, 12, W, 16, 128, slab_bytes=slab,
                             tokens=tokens) == autotune.paged_attn_cost(
        B, 12, W, 16, 128, slab_bytes=slab, tokens=tokens)


def test_flops_of_a_token():
    m = {"n_layers": 28, "d_model": 1536, "n_heads": 12, "n_kv_heads": 2,
         "head_dim": 128, "d_ff": 8960, "vocab_size": 151936}
    F = spec.family_module("transformer")
    # 1.31e9 projection parameters and the 233M-parameter head
    assert F.token_flops(m) == pytest.approx(2 * 1.3104e9, rel=1e-3)
    assert F.head_flops(m) == 2 * 1536 * 151936
    assert Y.least_s(989e12, 0) == pytest.approx(1.0)
