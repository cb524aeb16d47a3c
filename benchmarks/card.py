"""The card a run uses: its name and power limit, and its published peak
rates for roofline shares. Imports nothing heavy, so a script can ask for
the card before it imports JAX."""

import subprocess

# Published dense peaks per card, keyed by ``device_kind``. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM part, dense (no sparsity), at the
# full 700 W power limit. "f64" is the FP64 tensor-core rate; "f32" is
# FP32 outside the tensor cores, which is what "highest"-precision f32
# matmuls run at; "tf32" is what f32 matmuls get at default precision.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f64": 67e12, "f32": 67e12, "tf32": 495e12, "bf16": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind=None):
    """Peaks of the device ``kind`` (default: the first JAX device).
    A device missing from the table is an error, not a default."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def gpu_card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``name, power.limit``, one line per card). Raises when there is no
    ``nvidia-smi`` or it fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
