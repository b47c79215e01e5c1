"""Wall of the first sample after the CUDA context and the kernels are loaded: what a taxtk-binning process pays beyond its start-up."""


def read(ctx):
    return ctx["cold_sample_s"]
