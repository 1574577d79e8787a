from .logging import INFO, CAUTION, FATAL, OverridePrintWithTQDMWriteAndLog, ConditionalContextManager
from .timers import timethis, makeSecondsPretty
from .fsutil import (INVALID_FILENAME_CHARS, isInvalidFilename, hasExtension,
                     getFilesWithExtension, swapTupleValues)
from .device import select_device, device_description
from .spans import span
from .validators import (ValidateDatasetNameAndSplit, ValidateDatasetNameSplitAndIndex,
                         ValidateDistributedTrainingOptions)

__all__ = [
    'INFO', 'CAUTION', 'FATAL', 'OverridePrintWithTQDMWriteAndLog', 'ConditionalContextManager',
    'timethis', 'makeSecondsPretty',
    'INVALID_FILENAME_CHARS', 'isInvalidFilename', 'hasExtension', 'getFilesWithExtension', 'swapTupleValues',
    'select_device', 'device_description', 'span', 'ValidateDatasetNameAndSplit',
    'ValidateDatasetNameSplitAndIndex', 'ValidateDistributedTrainingOptions',
]
