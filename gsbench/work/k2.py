"""K2, the compositing backward: the per-intersection gradients of one
view.

Operations, per (pixel, entry) pair needed: the forward's walk again (16:
offset, quadratic form, exp, alpha and clamp, the transmittance), the
cotangent's dot with the four colours (7), the running prefix (2), the
alpha cotangent with its 1 / (1 - alpha) (7), the opacity's and sigma's
cotangents (3), the centre's (8) and the conic's (5) gradients, the
colours' (4) and the sums of the 10 gradient values over the tile's
pixels (10): 62. Bytes: the inputs read once (ids, tile ranges, 40 B a
Gaussian binned, and per pixel the forward's 20 B and their cotangents'
20 B) and each intersection's 10 gradient values written once (40 B).
"""

FLOPS_PER_PAIR = 62


def count(p) -> dict:
    return {"flops": FLOPS_PER_PAIR * p.pairs,
            "bytes": 4 * p.intersections + 8 * p.tiles + 40 * p.binned
            + 8 * (p.channels + 1) * p.pixels + 4 * (6 + p.channels) * p.intersections}
