"""The whole step's share of the card's bf16 peak over the traced
window: the FLOPs the model needs for the tokens it processed there
(2 per multiply-add of every projection a token passes, attention over
each row's live context, one row of logits per decoded token and per
prefill), over the window's seconds and 989 TFLOP/s.  Nothing the port
adds (dequantization, idle rows, padding) counts."""
from benchlib import yardstick as Y

LAYER = "model step"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    dev, work = rec["device"], rec["work"]
    if dev is None or work is None or dev.window_s <= 0:
        return None
    m = rec["model"]
    tok, head = Y.token_flops(m), Y.head_flops(m)
    flops = 0.0
    for ctx in work["contexts"]:
        flops += len(ctx) * (tok + head) + Y.attn_flops(m, sum(ctx))
    for P, c in work["prefills"]:
        n = P - c
        flops += n * tok + head + Y.attn_flops(
            m, (P * (P + 1) - c * (c + 1)) // 2)
    return 100.0 * flops / (dev.window_s * Y.PEAK_BF16_FLOPS)
