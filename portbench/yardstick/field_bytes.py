"""Bytes of the random-field programs' stages, from the grid alone.

A field of ``(nx, ny, nz)`` real values of ``itemsize`` bytes has three
components, each with a half spectrum of ``nx ny (nz // 2 + 1)`` complex
values of twice that size.  The least traffic of the transforms is six
transforms (three forward, three inverse), each reading its input once and
writing its output once; that of the k-space stage is the three half
spectra read once and written once, whatever implements the stage (the
slabs of eager arithmetic, or one kernel).
"""

from __future__ import annotations


def half_spectrum_bytes(shape, itemsize):
    """Bytes of one component's half spectrum."""
    nx, ny, nz = shape
    return nx * ny * (nz // 2 + 1) * 2 * itemsize


def fft_bytes(shape, itemsize):
    """Least bytes of a call's six transforms."""
    nx, ny, nz = shape
    return 2 * 3 * (nx * ny * nz * itemsize
                    + half_spectrum_bytes(shape, itemsize))


def kspace_bytes(shape, itemsize):
    """Least bytes of a call's k-space stage."""
    return 2 * 3 * half_spectrum_bytes(shape, itemsize)


def grid_of(ctx):
    """``(shape, itemsize)`` of the fields a run's calls made, from the
    driver's records, or ``None`` where they carry none."""
    shape = getattr(ctx.records, "shape", None)
    itemsize = getattr(ctx.records, "itemsize", None)
    if shape is None or not itemsize:
        return None
    return tuple(shape), itemsize
