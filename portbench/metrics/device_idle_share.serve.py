"""Share of the serving window in which no kernel, copy or memset ran on
the card, from the profiler's trace."""

from portbench.metrics._common import idle_share

UNIT = "%"


def read(art):
    return idle_share(art, "als_serve")
