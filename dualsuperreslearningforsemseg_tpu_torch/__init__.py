"""PyTorch/CUDA port of DSRL for NVIDIA Hopper.

A package beside the JAX one (``dualsuperreslearningforsemseg_tpu``), with
the same module layout and names.  It imports torch, numpy and PIL only.
Its hand-written CUDA kernels live in ``csrc/`` and are built by ``nvcc`` at
first use (``ops/_build.py``).  Entry points:
``python -m dualsuperreslearningforsemseg_tpu_torch <command> ...`` (the
commands of ``main.py``, ``__main__.py``) and
``python -m dualsuperreslearningforsemseg_tpu_torch.run_script <script> ...``.
"""
