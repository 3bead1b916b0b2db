"""The card's peak of allocated memory over the window (the peak counter
is reset after set-up), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
