"""Device milliseconds of a decode step: the kernels on the decode lane's
stream (the stream paged_attention runs on) in the traced stretch, over
the steps there (its paged_attention calls over the layers that make one
a step, ``flops.paged_layers``)."""
from benchlib import flops, readers


def read(run):
    t = getattr(run, "trace", None)
    if t is None:
        return None
    stream = readers.decode_stream(run)
    if stream is None:
        return None
    steps = len(readers.kernel_ops(run, "paged_attention")) / flops.paged_layers(run.arch)
    ops = [o for o in readers.in_window(t, t.ops)
           if o[3] == stream and not o[0].startswith(("Memcpy", "Memset"))]
    return 1e3 * t.seconds(ops) / steps if steps else None
