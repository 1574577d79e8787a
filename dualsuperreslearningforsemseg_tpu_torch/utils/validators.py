"""argparse validator Actions (parity: reference utils.py:101-180).

The user-visible error strings are the CLI contract and are kept verbatim.
"""

import argparse


def _nonneg_int(raw, message):
    """Parse a CLI token as an int >= 0; ``message`` on any failure."""
    if not raw.isnumeric():
        raise ValueError(message)
    return int(raw)


def _checked_dataset_and_split(datasets, dataset, split):
    """Casefold + membership-check a (dataset, split) pair against the
    registry; returns the normalized pair."""
    dataset, split = dataset.casefold(), split.casefold()
    if dataset not in datasets:
        raise ValueError("Unknown dataset! Supported datasets are: {:s}.".format(', '.join(datasets)))
    splits = datasets[dataset]['splits']
    if split not in splits:
        raise ValueError("Unknown dataset split! Supported splits are: {:s}.".format(', '.join(splits)))
    return dataset, split


class ValidateDatasetNameAndSplit(argparse.Action):
    """``--dataset NAME SPLIT`` — both must exist in the registry passed
    as ``const``."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, list(_checked_dataset_and_split(self.const, values[0], values[1])))


class ValidateDatasetNameSplitAndIndex(argparse.Action):
    """``--dataset NAME SPLIT START_INDEX`` — registry check plus a
    non-negative integer starting index (stored parsed)."""

    def __call__(self, parser, namespace, values, option_string=None):
        dataset, split = _checked_dataset_and_split(self.const, values[0], values[1])
        starting_index = _nonneg_int(
            values[2], "Starting index must be an integer greater or equal to 0!")
        setattr(namespace, self.dest, [dataset, split, starting_index])
