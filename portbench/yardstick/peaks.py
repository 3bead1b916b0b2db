"""Published peaks of the cards the benchmark runs on (data sheets, at the
full power limit), by the name ``torch.cuda.get_device_name`` gives."""

from __future__ import annotations

PEAKS = {
    # NVIDIA H100 SXM5 80GB: HBM3 at 3.35 TB/s
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name):
    """The peaks of ``device_name``, or ``None`` for a card not listed (a
    share of a peak is then not reported)."""
    return PEAKS.get(device_name)
