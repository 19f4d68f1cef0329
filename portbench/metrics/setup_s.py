"""setup_s: seconds from the start of the process to the start of the first
timed unit: the imports, the CUDA context, the fixture written and loaded,
the batch or the serving context built, the weights drawn, the kernels
loaded (built, in a checkout's first run) and the warm-up."""


def read(rec):
    return rec["setup_s"]
