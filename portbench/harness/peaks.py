"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set lower runs slower under
load, so a share of a peak is reported beside the card's limit)."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,  # outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "memory_bytes": 80e9,
}


def peaks_for(kind: str) -> dict:
    """The peak table of the card named ``kind``
    (``torch.cuda.get_device_name()``); raises for a card it lacks."""
    if "H100" in kind:
        return H100_SXM
    raise KeyError(f"no peak table for {kind!r}")
