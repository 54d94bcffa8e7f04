"""rows_roofline.gin_mlp.serve: the bytes K1 (scatter_add) must move in
the traced requests of the GIN + MLP configuration (per request one K1
per GIN sum and draw; bytes-bound, the frozen count of
``benchmark/archs/backbone_GIN.py``) at the HBM peak, over the device
time of K1's kernels, in %."""
from benchmark import archs, counts

KERNELS = ("scatter_slab_kernel", "scatter_direct_kernel")


def read(ctx):
    sh, f, cfg = ctx["shapes"], ctx["facts"], ctx["cell"].ref_cfg()
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("rows_roofline.gin_mlp.serve: no K1 kernel ran; "
                   f"longest: {ctx['trace'].unmatched(KERNELS)}")
        return None
    bb, q = archs.backbone(cfg), sh["q"]
    b = sum(bb.k1_eval_bytes(cfg, sh["n"][p], sh["e"][p], q, sh["draws"],
                             sh["e"][p] <= q) for p in f["parts"])
    return 100.0 * b / counts.PEAK_HBM_BPS / dev_s
