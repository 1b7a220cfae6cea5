"""Operations and bytes of one ``paged_decode`` call: one query token a
row, H query heads over K kv heads of D, each row over the ``lengths``
slots its own length covers (the padding rows of a step are not counted).
QK^T and PV, 4 D a slot and head; the covered keys and values, q and the
lengths read once, each covered page's table entry read once, the output
written once."""

# the kernel's name on the device
DEVICE_NAMES = ("paged_decode",)


def work(lengths, H: int, K: int, D: int, itemsize: int, page_size: int):
    slots = int(sum(int(n) for n in lengths))
    rows = len(lengths)
    pages = sum(-(-int(n) // page_size) for n in lengths)
    flops = 4 * H * D * slots
    nbytes = itemsize * (2 * K * D * slots + 2 * rows * H * D) + 4 * (rows + pages)
    return flops, nbytes
