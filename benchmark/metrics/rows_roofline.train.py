"""rows_roofline.train: the bytes K1 (scatter_add) and K2
(segment_sum_scalar) must move in the traced epochs of a GCN
configuration (bytes-bound, counted by ``benchmark/counts.py``) at the
HBM peak, over the device time of their kernels, in %."""
from benchmark import counts

KERNELS = ("scatter_slab_kernel", "scatter_direct_kernel",
           "segment_sum_kernel")


def read(ctx):
    sh, f, cell = ctx["shapes"], ctx["facts"], ctx["cell"]
    cfg, mode = cell.ref_cfg(), cell.mode
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("rows_roofline.train: no K1 or K2 kernel ran; longest: "
                   f"{ctx['trace'].unmatched(KERNELS)}")
        return None
    b = sum(counts.rows_train_bytes(cfg, mode, n, e, sh["q"])
            for n, e, a in zip(sh["n"], sh["e"], sh["plan"]) if a == 2)
    b += sum(counts.rows_eval_bytes(cfg, mode, n, e, sh["q"], sh["draws"])
             for n, e in zip(sh["n"], sh["e"]))
    return 100.0 * f["epochs"] * b / counts.PEAK_HBM_BPS / dev_s
