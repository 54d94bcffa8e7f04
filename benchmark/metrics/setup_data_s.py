"""setup_data_s: host seconds of the port's ``prepare_batches`` (the
partition, the induced subgraphs with the tile index, the copy to the
card, synchronised)."""


def read(ctx):
    return ctx["stages"]["data"]
