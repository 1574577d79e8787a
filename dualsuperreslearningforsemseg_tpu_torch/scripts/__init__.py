"""The port's copies of the auxiliary scripts (the repository's
``scripts/`` package), run by name through ``run_script``."""

from .calculate_dataset_mean_std import calculate_dataset_mean_std
from .show_augmented_inputs_targets import show_augmented_inputs_targets

__all__ = ['calculate_dataset_mean_std', 'show_augmented_inputs_targets']
