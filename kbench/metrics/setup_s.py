"""setup_s: seconds from the run's start to the end of its warm drain:
imports, the kernels' build or load, the weights, each tenant's submit and
the first drain's decisions."""


def read(rec):
    return rec["setup_s"]
