"""% of the traced serving units in which no operation ran on the card (device layer)."""

from portbench.core import readers


def read(run):
    return readers.idle_share(run)
