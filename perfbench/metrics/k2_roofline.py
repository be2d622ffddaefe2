"""K2 (``quant_paged_attention`` over the Q8 pool, every decode step's
attention): the least time of its launches in the traced window, each
over the live keys its rows attend (the family's ``k2_keys``, the
yardstick's frozen cost), over the device time of the kernels carrying
K2's symbols there.  K2 is bound by its bytes, which are affine in the
keys, so a step's launches take the least time of their mean keys."""
from benchlib import devtrace as DT
from benchlib import yardstick as Y

LAYER = "kernels"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    dev, work = rec["device"], rec["work"]
    if dev is None or work is None or not dev.k2_launches:
        return None
    F, m = rec["family"], rec["model"]
    per_step = F.k2_launches_per_step(m)
    steps = work["contexts"]
    if dev.k2_launches != per_step * len(steps):
        return None      # launched elsewhere than the steps counted here
    spent = DT.kernel_s(dev.ops, rec["k2_symbols"])
    if spent <= 0:
        return None
    slab = Y.q8_slab_bytes(m["n_kv_heads"], m["head_dim"])
    W = rec["max_len"] // rec["block_size"]
    least = sum(per_step * Y.least_s(*Y.paged_attn_cost(
        rec["n_slots"], m["n_heads"], W, rec["block_size"], m["head_dim"],
        slab_bytes=slab,
        tokens=sum(F.k2_keys(m, c) for c in ctx) / per_step))
        for ctx in steps)
    return 100.0 * least / spent
