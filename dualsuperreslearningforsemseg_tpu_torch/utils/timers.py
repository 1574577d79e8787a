"""Wall-clock timers (parity: reference utils.py:18-51)."""

from datetime import datetime


def makeSecondsPretty(time_elapsed):
    SECS_BOUND_WITH_UNIT = [(86400., 'days'), (3600., 'hrs'), (60., 'mins')]
    unit = 'secs'
    for secs_bound, bound_unit in SECS_BOUND_WITH_UNIT:
        if time_elapsed >= secs_bound:
            time_elapsed /= secs_bound
            unit = bound_unit
            break
    return "{0:.2f} {1:s}".format(time_elapsed, unit)


class timethis:
    """Prints ``message`` formatted with the block's wall time; the seconds
    are kept in ``elapsed``."""

    def __init__(self, message):
        self.message = message
        self.start_time = None
        self.elapsed = None

    def __enter__(self):
        self.start_time = datetime.now()
        return self

    def __exit__(self, exc_type, value, traceback):
        self.elapsed = (datetime.now() - self.start_time).total_seconds()
        print(self.message.format(makeSecondsPretty(self.elapsed)))
