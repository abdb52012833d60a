"""Peak device memory allocated during the window, in GB (10^9 bytes):
``torch.cuda.max_memory_allocated()`` after a reset at its start."""


def read(ctx):
    b = ctx.get("peak_bytes")
    return b / 1e9 if b else None
