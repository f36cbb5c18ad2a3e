"""A whole train step of the vanilla method on one view, in float32
operations, counted from what the step computes:

* projection and SH colour of every alive Gaussian (380: normalising the
  quaternion, its rotation, the 3D covariance, the view transform, the
  EWA Jacobian and 2D covariance, conic and radius, the pixel centre, the
  degree-3 SH basis and its 16 x 3 products, the opacity's sigmoid), and
  their backward for every Gaussian drawn in the view (twice that, 760);
* compositing forward and backward per pair needed (:mod:`.k1`,
  :mod:`.k2`), and the per-Gaussian sum of every intersection's 10
  gradient values (10 an intersection);
* the loss per pixel (2170: L1 over three channels, the five SSIM
  statistics filtered by an 11-tap window along each axis, the SSIM map,
  the clip and depth division of the outputs, and about twice all that for
  their backward);
* Adam per parameter of every alive lane (14: both moments, the bias
  corrections, the square root and the update) and the densify
  statistics (10 a lane).

Bytes are not counted: the step's share of the chip is of its operations.
"""

from gsbench.work import k1, k2

PROJECT_FWD, PROJECT_BWD = 380, 760
SEGMENT_SUM = 10
LOSS_PER_PIXEL = 2170
ADAM_PER_PARAM, STATS_PER_LANE = 14, 10


def count(p) -> dict:
    flops = (PROJECT_FWD * p.alive + PROJECT_BWD * p.drawn
             + k1.count(p)["flops"] + k2.count(p)["flops"]
             + SEGMENT_SUM * p.intersections + LOSS_PER_PIXEL * p.pixels
             + (ADAM_PER_PARAM * p.params_per_lane + STATS_PER_LANE) * p.alive)
    return {"flops": flops, "bytes": 0}
