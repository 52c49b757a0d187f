"""What a run's seed sets, beside the inputs each entry draws from it."""


def frame0_of(seed: int) -> int:
    """The window's first frame index: 1 plus a multiple of 1024 below 2^30.
    The renderer keys every random draw on (pixel, frame, sample, stream),
    so the seed changes the paths and not the work."""
    return 1 + (seed % (1 << 20)) * 1024
