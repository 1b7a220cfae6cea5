"""Operations and bytes of one ``flash_fwd`` call: causal attention of B
rows of S positions, H query heads over K kv heads of D.  QK^T and PV over
the causal pairs, 4 D a pair and head; q, k, v read once and the output
written once."""

# the kernel's name on the device
DEVICE_NAMES = ("flash_fwd",)


def work(B: int, S: int, H: int, K: int, D: int, itemsize: int, causal: bool = True):
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    nbytes = itemsize * (2 * B * S * H * D + 2 * B * S * K * D)
    return flops, nbytes
