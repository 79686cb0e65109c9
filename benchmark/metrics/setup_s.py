"""setup_s (host clock): process start to the first timed job: the
kernels' and the index's build where absent, index load, reads, one
warm-up job."""


def read(run):
    return run["setup_s"]
