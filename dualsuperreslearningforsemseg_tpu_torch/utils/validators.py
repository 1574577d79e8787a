"""argparse validator Actions (parity: reference utils.py:101-180).

The user-visible error strings are the CLI contract and are kept verbatim.
"""

import argparse


def _nonneg_int(raw, message):
    """Parse a CLI token as an int >= 0; ``message`` on any failure."""
    if not raw.isnumeric():
        raise ValueError(message)
    return int(raw)


def _positive_int(raw, not_int_message, not_positive_message):
    """Parse a CLI token as an int >= 1, with distinct contract messages."""
    value = _nonneg_int(raw, not_int_message)
    if value < 1:
        raise ValueError(not_positive_message)
    return value


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


class ValidateDistributedTrainingOptions(argparse.Action):
    """``--distributed MASTER_ADDR MASTER_PORT NODES DEVICES_PER_NODE BACKEND
    INIT_METHOD NODE_ID`` (reference main.py:118), stored as the mapping
    ``parallel.distributed_init_kwargs`` takes; ``const`` is the list of
    backends.  INIT_METHOD ``' '`` is the reference's "none" sentinel
    (``env://`` rendezvous) and is stored as None."""

    def __call__(self, parser, namespace, values, option_string=None):
        master_addr = values[0]
        master_port = _nonneg_int(values[1], "Master port must be a positive integer!")
        nodes = _positive_int(values[2], "Nodes must be a positive integer!",
                              "Nodes must be greater than 0!")
        devices_per_node = _positive_int(values[3], "Devices per node must be a positive integer!",
                                         "Devices per node must be greater than 0!")
        backend = values[4].casefold()
        if backend not in self.const:
            raise ValueError("Supported backends must be one of: [{:s}]!".format(', '.join(self.const)))
        init_method = values[5].casefold()
        if init_method == ' ':
            init_method = None
        node_id = _nonneg_int(values[6], "Node id must be an integer greater or equal to 0!")
        setattr(namespace, self.dest, dict(
            MASTER_ADDR=master_addr, MASTER_PORT=master_port, NODES=nodes,
            DEVICES_PER_NODE=devices_per_node, BACKEND=backend,
            INIT_METHOD=init_method, NODE_ID=node_id))
