"""A whole render request, in float32 operations: projection and SH
colour of every alive Gaussian (380 each, as :mod:`.step` counts them),
the compositing forward (:mod:`.k1`) and the outputs' background blend,
clip and depth division (10 a pixel). Bytes are not counted."""

from gsbench.work import k1
from gsbench.work.step import PROJECT_FWD

OUTPUT_PER_PIXEL = 10


def count(p) -> dict:
    return {"flops": PROJECT_FWD * p.alive + k1.count(p)["flops"]
            + OUTPUT_PER_PIXEL * p.pixels, "bytes": 0}
