"""scene_build_s: the host's seconds in the port's scene builders (meshes,
BVH, light tree, wide BVH, Morton order where the configuration asks),
the benchmark's ``scene_build`` span in set-up."""


def read(run):
    secs, n = run.rec.total("scene_build")
    return secs if n else None
