"""copy_ms.compress: device time of the host<->device copies (Memcpy HtoD and DtoH) a compress call, in ms."""

from perfbench import readers


def read(ctx):
    return readers.per_call_ms(ctx, "compress", lambda t: t.device_seconds("Memcpy HtoD", "Memcpy DtoH"))
