"""rows_roofline.gcnii.serve: the bytes the traced requests' propagations
must move at the HBM peak, over the device time of the kernels that do
them, in %. Per request: the GCN scorer's two propagations of nhid columns
over the partition's valid edges, and 9 GCNII propagations of 2048 columns
per draw over the q drawn edges (9 over the valid edges where a partition
has q or fewer); each ``prop_bytes`` of ``benchmark/archs/
backbone_GCNII.py``, which does not depend on the route. The kernels: K8's
binning, tile and gather kernels and K1's slab and direct kernels, taken
together, whichever route each call took."""
from benchmark import archs, counts

KERNELS = ("spmm_bin_count_kernel", "spmm_bin_scatter_kernel",
           "spmm_tile_kernel", "spmm_kernel", "scatter_slab_kernel",
           "scatter_direct_kernel")


def request_bytes(cfg, n, e, q, draws):
    """The propagations' bytes of one request on a partition of n real
    nodes and e valid edges."""
    bb = archs.backbone(cfg)
    if e <= q:
        return bb.LAYERS * bb.prop_bytes(n, e, bb.WIDTH)
    return (2 * bb.prop_bytes(n, e, cfg["nhid"])
            + draws * bb.LAYERS * bb.prop_bytes(n, q, bb.WIDTH))


def read(ctx):
    sh, f, cfg = ctx["shapes"], ctx["facts"], ctx["cell"].ref_cfg()
    dev_s, _ = ctx["trace"].kernel_seconds(KERNELS)
    if dev_s <= 0:
        ctx["log"]("rows_roofline.gcnii.serve: no K8 or K1 kernel ran; "
                   f"longest: {ctx['trace'].unmatched(KERNELS)}")
        return None
    b = sum(request_bytes(cfg, sh["n"][p], sh["e"][p], sh["q"], sh["draws"])
            for p in f["parts"])
    return 100.0 * b / counts.PEAK_HBM_BPS / dev_s
