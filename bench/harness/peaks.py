"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part): float32 outside the tensor cores, which the §5 trial
computes in, and the memory bandwidth, at the full power limit.
A roofline share is stated against these, with the card's power limit
printed beside it."""

PEAKS = {
    "H100": dict(fp32_flops=67e12, hbm_bytes_per_s=3.35e12),
}


def peaks_for(device_name: str):
    """The peaks of the card named ``device_name``, or ``None`` for a card
    the table does not hold (a reader then returns nothing)."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None
