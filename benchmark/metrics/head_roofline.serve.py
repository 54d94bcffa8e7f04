"""head_roofline.serve: K3 over every valid edge of each traced request
(operations-bound, ``benchmark/counts.py``) at the bf16 peak, over the
device time of the head kernel, in %."""
from benchmark import counts

KERNELS = ("head_mma_kernel",)


def read(ctx):
    sh, f, cfg = ctx["shapes"], ctx["facts"], ctx["cell"].ref_cfg()
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("head_roofline.serve: no head kernel ran; longest: "
                   f"{ctx['trace'].unmatched(KERNELS)}")
        return None
    ops = sum(counts.head_eval_flops(cfg, sh["e"][p]) for p in f["parts"])
    return 100.0 * ops / counts.PEAK_BF16_FLOPS / dev_s
