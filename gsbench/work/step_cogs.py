"""A whole train step of co-gs with SO(3) x R3 camera optimisation on one
view, in float32 operations: the vanilla step's (:mod:`.step`) and what
co-gs adds, counted from what the step computes:

* the sensor depth L1 (6 a pixel: the difference, its select |x|, the
  mask's product and the sums, about twice that again for their
  backward: 18);
* the planar prior over 16 patches of 128 x 128 pixels: per point the
  back-projection (6), the centring (3 and the mean's 3), its share of the
  3 x 3 covariance (18) and of the point-to-plane distance (6), and
  about twice all that for the backward (108 a point); the 16 eigen
  solves of 3 x 3 (about 1,000 each);
* the camera: the exp map and the adjusted pose (about 150, 450 with its
  backward), the pose penalty over every camera's six numbers (about 6 a
  number, 18 with its backward), the camera group's Adam (14 a number),
  and the projection backward's 24 view-gradient terms of every Gaussian
  drawn in the view (a product and a sum each, 48) with their sum over
  the lanes.

The number of train cameras is not in a pass: the camera group's own
operations (penalty and Adam over 210 x 6 numbers, about 40k) are taken
at the configuration's 210 views; at 1M lanes they are 1e-6 of the step.
Bytes are not counted.
"""

from gsbench.work import step

DEPTH_PER_PIXEL = 18
PLANAR_POINTS, PLANAR_PER_POINT, EIGH = 16 * 128 * 128, 108, 16 * 1000
EXP_MAP = 450
CAMERA_NUMBERS, PENALTY_PER_NUMBER, ADAM_PER_NUMBER = 210 * 6, 18, 14
VIEW_GRAD_PER_DRAWN = 48


def count(p) -> dict:
    flops = (step.count(p)["flops"] + DEPTH_PER_PIXEL * p.pixels
             + PLANAR_PER_POINT * PLANAR_POINTS + EIGH + EXP_MAP
             + (PENALTY_PER_NUMBER + ADAM_PER_NUMBER) * CAMERA_NUMBERS
             + VIEW_GRAD_PER_DRAWN * p.drawn)
    return {"flops": flops, "bytes": 0}
