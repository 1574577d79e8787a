"""Run one of the port's auxiliary scripts (``scripts/`` of this package)
by name:

    python -m dualsuperreslearningforsemseg_tpu_torch.run_script <SCRIPT_NAME> [SCRIPT_ARGS...]

The help and exit codes of the repository's ``run_script.py``: no name or
``-h`` prints the usage and the script names and exits 0; an unknown name
exits 1.
"""

import sys

from . import scripts
from .utils import FATAL, OverridePrintWithTQDMWriteAndLog


def _script_names():
    return sorted(name for name in dir(scripts)
                  if not name.startswith('_') and callable(getattr(scripts, name)))


def main(argv) -> int:
    if not argv or argv[0].casefold() in ('-h', '--help'):
        print("Runs an auxiliary script from the 'scripts' package.\n"
              "Usage: python -m dualsuperreslearningforsemseg_tpu_torch.run_script <SCRIPT_NAME> [SCRIPT_ARGS...]\n"
              "Available scripts: {:s}\n"
              "Pass '-h' after a script name for that script's own help."
              .format(', '.join(_script_names())))
        return 0

    script = getattr(scripts, argv[0], None)
    if not callable(script):
        print(FATAL("No script named '{:s}'; available: {:s}".format(
            argv[0], ', '.join(_script_names()))))
        return 1
    script(argv[1:])
    return 0


if __name__ == '__main__':
    with OverridePrintWithTQDMWriteAndLog():
        sys.exit(main(sys.argv[1:]))
