"""File-name helpers (parity: reference utils.py)."""

import os

INVALID_FILENAME_CHARS = ('<', '>', ':', '"', '/', '\\', '|', '?')


def isInvalidFilename(filename):
    return any(c in filename for c in INVALID_FILENAME_CHARS)


def getFilesWithExtension(dir_, extension_or_tuple, with_path=False):
    if not isinstance(extension_or_tuple, tuple):
        extension_or_tuple = (extension_or_tuple,)
    extension_or_tuple = tuple(x.casefold() for x in extension_or_tuple)
    return [(os.path.join(dir_, f) if with_path else f)
            for f in sorted(os.listdir(dir_))
            if f.casefold().endswith(extension_or_tuple)]


def hasExtension(filename, extension):
    return os.path.splitext(filename)[-1].casefold() == extension.casefold()


def swapTupleValues(t):
    assert type(t) in [tuple, list] and len(t) == 2, "Only tuple of size 2 is supported!"
    return type(t)((t[1], t[0]))
