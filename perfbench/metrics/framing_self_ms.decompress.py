"""framing_self_ms.decompress: host time of the program's rsnb.decompress range outside the ranges
nested in it (the header, the output buffer and the copy into bytes), in ms a call."""

from perfbench import readers


def read(ctx):
    phase = ctx.phases.get("decompress")
    t = phase.trace if phase else None
    spans = len(t.spans("rsnb.decompress")) if t is not None else 0
    return t.self_s("rsnb.decompress") * 1e3 / spans if spans else None
