"""K1, the compositing forward: the work of one view's compositing.

Operations, per (pixel, entry) pair needed (:class:`gsbench.work.Pass`):
the offset to the centre (2), the conic's quadratic form (9), exp(-sigma)
(2), alpha = op e and its clamp (2), 1 - alpha and the transmittance's
product (2), the weight T alpha (1) and the weighted sum of the four
channels (8): 26. Bytes: each input read once (one 4-B Gaussian id per
intersection, one 8-B range per tile, 40 B of position, conic, opacity and
colour per Gaussian binned) and each output written once (the four
accumulated channels and the final transmittance of every pixel, 20 B).
"""

FLOPS_PER_PAIR = 26


def count(p) -> dict:
    return {"flops": FLOPS_PER_PAIR * p.pairs,
            "bytes": 4 * p.intersections + 8 * p.tiles + 40 * p.binned
            + 4 * (p.channels + 1) * p.pixels}
