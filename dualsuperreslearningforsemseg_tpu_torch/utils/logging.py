"""Console plumbing (reference utils.py:54-99,183-190, as the JAX package's
``utils/logging.py`` has it): the coloured INFO/CAUTION/FATAL prefixes, a
context manager that tees ``print`` through ``tqdm.write`` into a log file,
and a conditional context manager.

The colours are written as plain ANSI escape codes, the ones ``termcolor``
emits, so the port needs no package beyond torch, numpy, PIL and tqdm.
"""

import builtins
import contextlib
import sys

from tqdm.auto import tqdm

# Severity tag -> ANSI SGR codes (green; yellow; red + reverse + blink).
_SEVERITY_STYLE = {
    'INFO': '32',
    'CAUTION': '33',
    'FATAL': '31;7;5',
}


def _tagged(tag, text, prefix):
    return "\033[{}m{}{}: {}\033[0m".format(_SEVERITY_STYLE[tag], prefix, tag, text)


def INFO(text, prefix=''):
    return _tagged('INFO', text, prefix)


def CAUTION(text, prefix=''):
    return _tagged('CAUTION', text, prefix)


def FATAL(text, prefix=''):
    return _tagged('FATAL', text, prefix)


class OverridePrintWithTQDMWriteAndLog:
    """Tee ``sys.stdout`` to an optional log file and route ``print``
    through ``tqdm.write`` so progress bars are not clobbered by log lines.

    While active, ``sys.stdout`` is this instance, and every ``write`` /
    ``flush`` goes to the real stdout and to the log file.  ``print`` falls
    back to the builtin when ``tqdm.write`` raises.  With ``master=False``
    (a rank of multi-process training other than rank 0) no log file is
    opened: only the master keeps one.
    """

    def __init__(self, log_filename=None, master=True):
        self._log_filename = log_filename if master else None
        self._sinks = (sys.stdout,)
        self._saved = None  # (sys.stdout, builtins.print) while active

    def write(self, text):
        for sink in self._sinks:
            sink.write(text)

    def flush(self):
        for sink in self._sinks:
            sink.flush()

    def __enter__(self):
        real_stdout, real_print = sys.stdout, builtins.print
        self._saved = (real_stdout, real_print)
        self._sinks = (real_stdout,)
        if self._log_filename:
            self._sinks += (open(self._log_filename, 'w+'),)

        def print_via_tqdm(*args, **kwargs):
            try:
                tqdm.write(*args, **kwargs)
            except Exception:
                real_print(*args, **kwargs)

        sys.stdout = self
        builtins.print = print_via_tqdm
        return self

    def __exit__(self, exc_type, exc_value, exc_traceback):
        if self._saved is None:
            return
        real_stdout = self._saved[0]
        sys.stdout, builtins.print = self._saved
        for sink in self._sinks[1:]:  # close only the log file this opened
            sink.close()
        # Whatever captured this instance as its stream keeps writing to
        # the real stdout; only the log file stops.
        self._sinks = (real_stdout,)
        self._saved = None


class ConditionalContextManager:
    """``with ConditionalContextManager(pred, make_ctx) as x`` enters
    ``make_ctx()`` when ``pred`` is truthy, otherwise ``func_false()``
    (default: yields ``None``).  A factory may return a plain value instead
    of a context manager; it is passed through unmanaged."""

    def __init__(self, expr_to_check, func_true, func_false=lambda: None):
        if not (callable(func_true) and callable(func_false)):
            raise TypeError("ConditionalContextManager needs two callables")
        made = (func_true if expr_to_check else func_false)()
        if not hasattr(made, '__enter__'):
            made = contextlib.nullcontext(made)
        self._ctx = made

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, exc_type, exc_value, exc_traceback):
        return self._ctx.__exit__(exc_type, exc_value, exc_traceback)
