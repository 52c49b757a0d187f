"""setup_in_port_s: the seconds of set-up inside the port's outermost set-up
spans (``scene.compile``, ``scene.morton``, ``scene.upload``,
``kernels.load``, ``kernels.first_launch``, ...; ``gpubench/program.py``);
``setup_s`` less this is imports, the CUDA context and the benchmark's own
code.  Nothing where the port keeps no set-up spans."""

from gpubench import program


def read(run):
    return program.setup_in_port_s(run)
