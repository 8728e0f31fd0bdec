"""expand_ms.stream: device time of the kernels launched under the program's stream.enc.expand range
(the event records' expansion into bits), in ms a 10^6 bytes of input."""

from perfbench import readers


def read(ctx):
    t = readers.trace(ctx, "compress")
    mb = sum(c.nbytes for c in readers.calls(ctx, "compress")) / 1e6
    if t is None or mb == 0:
        return None
    device_s = t.launched_under_s("stream.enc.expand")
    return device_s * 1e3 / mb if device_s > 0 else None
