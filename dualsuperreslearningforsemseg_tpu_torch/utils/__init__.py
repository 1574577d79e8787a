from .logging import INFO, CAUTION, FATAL
from .timers import timethis, makeSecondsPretty
from .fsutil import (INVALID_FILENAME_CHARS, isInvalidFilename, hasExtension,
                     getFilesWithExtension, swapTupleValues)
from .device import select_device, device_description
from .validators import ValidateDatasetNameAndSplit

__all__ = [
    'INFO', 'CAUTION', 'FATAL', 'timethis', 'makeSecondsPretty',
    'INVALID_FILENAME_CHARS', 'isInvalidFilename', 'hasExtension', 'getFilesWithExtension', 'swapTupleValues',
    'select_device', 'device_description', 'ValidateDatasetNameAndSplit',
]
