"""One module per architecture, ``<model>.py`` (the configuration's ``model``
key, lower-cased), which holds everything the harness needs to know of it:

* ``program_env(cfg)``: {variable: value} of the program's own settings
  that size this model, set before the program is imported;
* ``program(cfg)``: the program's model on the meta device (the seeded
  weights are loaded after);
* ``reference(cfg)``: the plain model of ``reference/``, built under the
  caller's device;
* ``weight_rules(cfg)``: the seeding rules of ``weights.py`` for what its
  default rules do not cover or should seed otherwise, tried first;
* ``terms(cfg, outputs, hi, seg)``: {name: loss term} of a reference train
  step, from the forward's ``outputs``, the high-resolution input ``hi``
  (B, 3, *output_hw) and the labels ``seg`` (B, *output_hw), in the order
  the program reports them;
* ``logits(outputs)``: the (B, classes, *output_hw) class logits of an eval
  or test forward;
* ``tiny(cfg)``: the keys that shrink the configuration for the CPU tests.
"""

import importlib


def find(cfg):
    """The model module of the configuration ``cfg``."""
    return importlib.import_module(__name__ + '.' + cfg['model'].lower())
