"""libs_s: the seconds of set-up inside the port's library spans: the kernel
libraries' first load (``kernels.load``: hash, nvcc where it builds,
dlopen), the C++ builders' (``native.load``) and each C entry's first
call, where CUDA loads its module (``kernels.first_launch``), their union
(``gpubench/program.py``).  Nothing where the port keeps none of them."""

from gpubench import program


def read(run):
    return program.libs_s(run)
