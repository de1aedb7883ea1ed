"""The share of a step's rays that the Levenberg-Marquardt residuals keep:
the program's ``lm.inliers`` counter (hits with target depth whose
residual is inside the band) over the rays of the traced steps, in
percent."""


def read(t):
    if t is None:
        return None
    inliers = t.extras.get("counters", {}).get("lm.inliers")
    rays = t.extras.get("rays_per_step")
    if inliers is None or not rays:
        return None
    share = t.per_unit(100.0 * inliers / rays)
    return share
