"""The plain reference the benchmark judges the system under test by.

Plain PyTorch and NumPy only: it imports neither the path tracer's port
nor its JAX package, and takes nothing either has made.  It builds its
own scenes (``scenes``), light tree (``lighttree_build``) and closest-hit
walk (``bvh``) from the scene descriptions, and recomputes what the timed
path produced: pixel sums of NEE frames (``nee``) and SGD steps of the
inverse-rendering loss (``diff``).  The type of the scene's float arrays
is the type of its arithmetic, so the same code at a lower precision is
the control that a check must fail.
"""
