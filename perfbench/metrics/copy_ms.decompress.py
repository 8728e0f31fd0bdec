"""copy_ms.decompress: device time of the host<->device copies (Memcpy HtoD and DtoH) a decompress call, in ms."""

from perfbench import readers


def read(ctx):
    return readers.per_call_ms(ctx, "decompress", lambda t: t.device_seconds("Memcpy HtoD", "Memcpy DtoH"))
