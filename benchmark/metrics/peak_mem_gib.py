"""The caching allocator's peak (torch.cuda.max_memory_allocated) over
set-up and window, in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
