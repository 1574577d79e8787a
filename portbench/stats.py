"""The statistics the harness reports."""


def percentile(values, q):
    """The ``q``-th percentile (0..100) of all ``values``, linear between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
