"""RWKV-6's float32 floor, shared by the split tests of its training and
of its decode: how far reassociating its products' sums alone moves a
result of the whole model, in one process, with no collective."""
import contextlib

from repro_torch.models import rwkv6

FLOOR_FACTOR = 3         # a split's bar: this many times the floor at its M


@contextlib.contextmanager
def products_in_parts(parts: int):
    """Every ``rwkv6._f32_product`` inside the block with its contraction
    summed in ``parts`` float32 parts (``tensor_split``), as a split over
    ``parts`` ranks sums its partial products: run the whole model under
    it and compare with its plain run to read the floor at that M."""
    product = rwkv6._f32_product

    def in_parts(a, w):
        return sum(product(ai, wi) for ai, wi in
                   zip(a.tensor_split(parts, -1), w.tensor_split(parts, 0)))
    rwkv6._f32_product = in_parts
    try:
        yield
    finally:
        rwkv6._f32_product = product


def bar(base: float, floor: float) -> float:
    """A split's bar: ``base``, or ``FLOOR_FACTOR`` times the measured
    floor where that is larger."""
    return max(base, FLOOR_FACTOR * floor)
