"""The plain reference against the port's plain kernels on a tiny
W4A16-tileable model: the same quantized values, and the logits the
port's paged engine samples from."""
import numpy as np
import pytest
import torch

from tiny import CONFIG, port_cfg

from benchlib import spec

ref = spec.reference_module("transformer")
family = spec.family_module("transformer")


def test_weight_and_kv_quantization_match_the_port():
    from repro_torch.quant import tile_quant as TQ
    from repro_torch.serving import kv_quant as KQ

    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 96), generator=g) * 0.3
    assert torch.equal(ref.q4_tile(w), TQ.dequantize(TQ.quantize(w)))
    wd = torch.randn((128, 64), generator=g)
    assert torch.equal(ref.q8_groups(wd),
                       TQ.dequantize_q8(TQ.quantize_q8(wd)))
    kv = torch.randn((5, 7, 2, 16), generator=g) * 3
    assert torch.equal(ref.kv_q8(kv), KQ.dequantize_kv(
        KQ.quantize_kv(kv, mode="q8", gr=2, gc=16)))


def test_logits_match_the_ports_paged_engine():
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.sampler import SamplerConfig

    model = family.dims(CONFIG)
    top, layers = family.make_weights(model, 3, "cpu")
    params = cast_params(quantize_model_params(
        dict(top, layers=list(layers))), torch.float32)
    engine = DecodeEngine(params, port_cfg(), max_len=64, paged=True,
                          block_size=16, n_blocks=9, kv_quant="q8")
    P, n = 21, 14
    prompt = torch.randint(3, 512, (1, P), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    st = engine.prefill(prompt, torch.tensor([P], dtype=torch.int32))
    got, toks = [], []
    for _ in range(n):
        got.append(st.pending_logits[0].clone())
        st, tok = engine.step(st, None, SamplerConfig(greedy=True))
        toks.append(int(tok[0]))
    w = ref.prepare(*family.make_weights(model, 3, "cpu"))
    seq = torch.as_tensor(np.concatenate([prompt[0].numpy(), toks[:-1]]))
    want = ref.sequence_logits(w, model, seq, P, 0, range(P - 1, P - 1 + n))
    assert torch.allclose(torch.stack(got), want, atol=2e-5, rtol=0)
    assert want.std() > 0.1


@pytest.mark.parametrize("act", ["fp8_rows", "bf16"])
def test_the_controls_round(act):
    x = torch.randn(4, 64) * 5
    y = getattr(ref, act)(x)
    assert not torch.equal(x, y)
    assert torch.allclose(x, y, rtol=0.07, atol=1e-3)
