"""head_roofline.train: the score head's work in the traced epochs (K6
over every valid edge and K3 + K5 on the q winners of each sampled step,
K3 over every valid edge of each eval; operations-bound, counted by
``benchmark/counts.py``) at the bf16 peak, over the device time of the
head kernels, in %."""
from benchmark import counts

KERNELS = ("head_mma_kernel", "head_bwd_mma_dz1_kernel",
           "head_bwd_mma_dh_kernel", "head_bwd_mma_dw_kernel")


def read(ctx):
    sh, f, cfg = ctx["shapes"], ctx["facts"], ctx["cell"].ref_cfg()
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("head_roofline.train: no head kernel ran; longest: "
                   f"{ctx['trace'].unmatched(KERNELS)}")
        return None
    ops = sum(counts.head_train_flops(cfg, e, sh["q"])
              for e, a in zip(sh["e"], sh["plan"]) if a == 2)
    ops += sum(counts.head_eval_flops(cfg, e) for e in sh["e"])
    return 100.0 * f["epochs"] * ops / counts.PEAK_BF16_FLOPS / dev_s
