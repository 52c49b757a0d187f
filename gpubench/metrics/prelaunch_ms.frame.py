"""prelaunch_ms.frame: the host's milliseconds from the start of the port's
call span (``mk.call``, inside ``render_many``) to the end of its K2
launch span (``k2.launch``), a mean over the window's calls, from the
port's own spans (``gpubench/program.py``): in a closed loop, the host
work the card waits for before each launch.  Nothing where the port keeps
no such spans (an untraced run, a port without them, the CPU's plain path)."""

from gpubench import program


def read(run):
    if run.unit != "frame":
        return None
    return program.prelaunch_ms(run)
