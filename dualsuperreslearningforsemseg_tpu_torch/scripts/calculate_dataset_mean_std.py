"""Compute per-channel mean/std over a dataset split — the source of the
MEAN/STD constants (parity: reference scripts/calculate_dataset_mean_std.py:
12-48: mean of per-image channel means/stds), in numpy float64 on the
host."""

import argparse

import numpy as np
from tqdm.auto import tqdm

from .. import consts, settings
from ..utils import ValidateDatasetNameAndSplit


def calculate_dataset_mean_std(args):
    """Returns ``(means, stds)``, one float per RGB channel."""
    parser = argparse.ArgumentParser(
        description="Calculate mean and standard deviation from the dataset's specified split.")
    parser.add_argument('--dataset', required=True, nargs=2, metavar=('DATASET', 'SPLIT'),
                        action=ValidateDatasetNameAndSplit, const=settings.DATASETS,
                        help="Dataset and split to operate on")
    args = parser.parse_args(args)

    entry = settings.DATASETS[args.dataset[0]]
    dataset = entry['class'](entry['path'], split=args.dataset[1])

    means = [[] for _ in range(consts.NUM_RGB_CHANNELS)]
    stds = [[] for _ in range(consts.NUM_RGB_CHANNELS)]
    for i in tqdm(range(len(dataset)), desc='CALCULATING', colour='green'):
        img, _ = dataset[i]
        x = img.astype(np.float64) / 255.0
        for channel in range(consts.NUM_RGB_CHANNELS):
            means[channel].append(x[..., channel].mean())
            stds[channel].append(x[..., channel].std(ddof=1))

    means = tuple(np.mean(means[c]) for c in range(consts.NUM_RGB_CHANNELS))
    stds = tuple(np.mean(stds[c]) for c in range(consts.NUM_RGB_CHANNELS))
    print("\n---- RESULTS ---")
    print("Avg. mean: ({0:.5f}, {1:.5f}, {2:.5f})".format(*means))
    print("Avg. standard deviation: ({0:.5f}, {1:.5f}, {2:.5f})".format(*stds))
    return means, stds
