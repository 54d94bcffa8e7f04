"""rows_roofline.gin_mlp.train: the bytes K1 (scatter_add) must move in
the traced epochs of the GIN + MLP configuration (every trained step and
every partition's eval; bytes-bound, the frozen count of
``benchmark/archs/backbone_GIN.py``) at the HBM peak, over the device
time of K1's kernels, in %."""
from benchmark import archs, counts

KERNELS = ("scatter_slab_kernel", "scatter_direct_kernel")


def read(ctx):
    sh, f, cfg = ctx["shapes"], ctx["facts"], ctx["cell"].ref_cfg()
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("rows_roofline.gin_mlp.train: no K1 kernel ran; "
                   f"longest: {ctx['trace'].unmatched(KERNELS)}")
        return None
    bb, q = archs.backbone(cfg), sh["q"]
    b = sum(bb.k1_step_bytes(cfg, n, e, q, a)
            for n, e, a in zip(sh["n"], sh["e"], sh["plan"]) if a)
    b += sum(bb.k1_eval_bytes(cfg, n, e, q, sh["draws"], e <= q)
             for n, e in zip(sh["n"], sh["e"]))
    return 100.0 * f["epochs"] * b / counts.PEAK_HBM_BPS / dev_s
