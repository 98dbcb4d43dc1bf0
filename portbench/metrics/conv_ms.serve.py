"""Device ms a serving unit (a frame, or a rig step) in the convolution
families of the trace (models layer)."""

from portbench.core import readers


def read(run):
    return readers.conv_ms(run)
