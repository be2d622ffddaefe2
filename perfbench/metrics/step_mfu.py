"""The whole step's share of the card's bf16 peak over the traced
window: the FLOPs the model needs for the tokens it processed there
(2 per multiply-add of every projection a token passes, attention over
each row's live context, one row of logits per decoded token and per
prefill; the family's rules, ``families/<reference>.py``), over the
window's seconds and 989 TFLOP/s.  Nothing the port adds
(dequantization, idle rows, padding) counts."""
from benchlib import yardstick as Y

LAYER = "model step"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    dev, work = rec["device"], rec["work"]
    if dev is None or work is None or dev.window_s <= 0:
        return None
    F, m = rec["family"], rec["model"]
    tok, head = F.token_flops(m), F.head_flops(m)
    flops = 0.0
    for ctx in work["contexts"]:
        flops += len(ctx) * (tok + head) + sum(F.attn_flops(m, c)
                                               for c in ctx)
    for P, c in work["prefills"]:
        # the prompt's uncached positions, each over its causal context
        flops += (P - c) * tok + head + sum(F.attn_flops(m, q)
                                            for q in range(c + 1, P + 1))
    return 100.0 * flops / (dev.window_s * Y.PEAK_BF16_FLOPS)
