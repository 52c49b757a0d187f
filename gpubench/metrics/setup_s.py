"""setup_s: process start to the first timed update (imports, CUDA context,
kernel libraries, scene build, upload, warm-up), on the host's clock."""


def read(run):
    return run.setup_s
