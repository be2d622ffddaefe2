"""K3 (``lut_dequant_gemm``, every Q4 projection): the least time of the
launches ``kernels/ops.gemm_launches_by_shape`` counted in the traced
window (the yardstick's frozen cost: x read once, out written once,
codes, tile scales and codebook), over the device time of the kernels
carrying K3's symbols there."""
from benchlib import devtrace as DT
from benchlib import yardstick as Y

LAYER = "kernels"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    dev = rec["device"]
    if dev is None or not dev.k3_shapes:
        return None
    spent = DT.kernel_s(dev.ops, rec["k3_symbols"])
    if spent <= 0:
        return None
    least = sum(n * Y.least_s(*Y.gemm_cost(M, K, N))
                for (M, K, N), n in dev.k3_shapes.items())
    return 100.0 * least / spent
