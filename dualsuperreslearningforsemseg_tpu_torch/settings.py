"""Global settings of the PyTorch port.

The same configuration surface as the JAX package's ``settings.py`` (itself
parity with reference settings.py:11-80), with the port's devices:

* devices are ``cpu`` / ``cuda``, and the default is ``cuda``: an entry point
  without a card raises unless the caller asks for ``--device cpu``;
* the same ``DSRL_TPU_MODEL_INPUT_SIZE`` / ``DSRL_TPU_BACKBONE_LAYERS``
  overrides shrink the model for tests, so one environment sizes both
  packages alike;
* mixed precision is bf16 autocast with float32 parameters: the apex
  opt-level strings O1-O3 and 'BF16' map to bfloat16, None/'O0' to float32.
"""

import os
import os.path

import torch

SUPPORTED_DEVICES = ['cpu', 'cuda']
# --distributed BACKEND (reference settings.py:24): torch.distributed's
# backends, and the JAX package's 'xla', which maps to the device's default
# (parallel/mesh.py::distributed_init_kwargs).
SUPPORTED_DISTRIBUTED_BACKENDS = ['gloo', 'mpi', 'nccl', 'xla']
RANDOM_SEED = 54321                         # parity: reference settings.py:25

# Mixed precision options: apex opt-levels accepted for CLI parity
# (reference settings.py:28); any of O1/O2/O3/BF16 -> bf16 compute.
AMP_OPTIMIZATION_OPTIONS = [None, 'O0', 'O1', 'O2', 'O3', 'BF16']

# Default values for commandline arguments (reference settings.py:30-43)
DEFAULT_DEVICE = 'cuda'
DEFAULT_AMP_OPTIMIZATION_OPTION = AMP_OPTIMIZATION_OPTIONS[0]
DEFAULT_NUM_WORKERS = max(1, min(16, os.cpu_count() or 4))
DEFAULT_VAL_INTERVAL = 10
DEFAULT_CHECKPOINT_INTERVAL = 5
DEFAULT_CHECKPOINT_HISTORY = 5
DEFAULT_BATCH_SIZE = 4
DEFAULT_LEARNING_RATE = 0.01
DEFAULT_END_LEARNING_RATE = 0.001
DEFAULT_MOMENTUM = 0.9
DEFAULT_WEIGHTS_DECAY = 0.0005
DEFAULT_POLY_POWER = 0.9
DEFAULT_LOSS_WEIGHTS = [0.1, 1.0]

# Formats, directories and files (reference settings.py:45-58)
EXPERIMENTS_ROOT_DIR = 'experiments'
WEIGHTS_ROOT_DIR = 'weights'
WEIGHTS_DIR = os.path.join(WEIGHTS_ROOT_DIR, 'stage{stage}')
FINAL_WEIGHTS_FILE = 'final.weights'
CHECKPOINTS_DIR = os.path.join(WEIGHTS_DIR, 'checkpoints')
CHECKPOINT_FILE = 'epoch{epoch}.checkpoint'
LOGS_DIR = os.path.join('logs', 'stage{stage}', '{mode}')
PARAMS_FILE = 'params.txt'
STDOUT_FILE = 'stdout.txt'
OUTPUTS_DIR = 'outputs'
PROFILING_FILE = 'profiling.json'
PROFILING_RANK_FILE = 'profiling_rank{rank}.json'   # rank r of --distributed training
PROFILING_DIR = os.path.join(OUTPUTS_DIR, 'profile')
DATASETS_DIR = 'datasets'

# Model parameters (reference settings.py:60-63).
STAGES = [1, 2, 3]

# The env override exists for tests/smoke runs on tiny inputs (H and W must
# be multiples of 16).
_size_env = os.environ.get('DSRL_TPU_MODEL_INPUT_SIZE')
if _size_env:
    MODEL_INPUT_SIZE = tuple(int(x) for x in _size_env.lower().split('x'))
else:
    MODEL_INPUT_SIZE = (256, 512)
MODEL_OUTPUT_SIZE = tuple(x * 2 for x in MODEL_INPUT_SIZE)

# Backbone depth (ResNet-101 = 3,4,23,3).  The env override shrinks the
# backbone for tests (structurally identical, far faster on a CPU).
_layers_env = os.environ.get('DSRL_TPU_BACKBONE_LAYERS')
BACKBONE_LAYERS = tuple(int(x) for x in _layers_env.split(',')) if _layers_env \
    else (3, 4, 23, 3)


# Dataset registry (reference settings.py:65-74).  The 'class' entry is a
# factory (root, split) -> data.reader dataset object.
def _cityscapes_factory(path, split, transforms=None):
    from .data.reader import CityscapesDataset
    return CityscapesDataset(path, split=split, transforms=transforms)


from .datasets import cityscapes as _cityscapes_settings  # noqa: E402

DATASETS = {
    'cityscapes': {
        'path': os.path.join(DATASETS_DIR, 'Cityscapes', 'data'),
        'splits': ['train', 'val', 'test'],
        'class': _cityscapes_factory,
        'settings': _cityscapes_settings,
    },
}
DATASETS = {k.casefold(): v for k, v in DATASETS.items()}

# Checkpoint schema (reference settings.py:76-80): the same 36 entries as
# the JAX package's list, 'amp_state_dict' twice among them.
VARIABLES_IN_CHECKPOINT = \
['device', 'mixed_precision', 'amp_state_dict', 'disable_cudnn_benchmark', 'num_workers', 'val_interval', 'checkpoint_interval', 'checkpoint_history', 'init_weights',
 'batch_size', 'epochs', 'learning_rate', 'end_learning_rate', 'momentum', 'weights_decay', 'poly_power', 'stage', 'w1', 'w2', 'freeze_batch_norm', 'experiment_id',
 'description', 'early_stopping', 'CE_train_avg_loss', 'MSE_train_avg_loss', 'FA_train_avg_loss', 'Avg_train_loss', 'CE_val_avg_loss', 'MSE_val_avg_loss',
 'FA_val_avg_loss', 'Avg_val_loss', 'epoch', 'best_validation_dict', 'model_state_dict', 'optimizer_state_dict', 'amp_state_dict']

# Device names a JAX-era checkpoint or recipe may hold -> the port's.
_PORT_DEVICE = {'cpu': 'cpu', 'tpu': 'cuda', 'gpu': 'cuda', 'cuda': 'cuda'}


def port_device(device: str) -> str:
    """The port's device for a device name from a checkpoint or a
    ``config-train`` file: ``cpu`` stays ``cpu``; the accelerator names
    ``tpu``, ``gpu`` and ``cuda`` become ``cuda`` (which raises later on a
    machine without a card; it never turns into the CPU)."""
    name = str(device).casefold()
    if name not in _PORT_DEVICE:
        raise ValueError("Unknown device '{}': expected one of {}.".format(
            device, ', '.join(sorted(_PORT_DEVICE))))
    return _PORT_DEVICE[name]


def mixed_precision_to_dtype(mixed_precision) -> torch.dtype:
    """The compute dtype of a mixed-precision option: None/'O0' -> float32,
    'O1'/'O2'/'O3'/'BF16' -> bfloat16 (no loss scaling is needed for bf16)."""
    if mixed_precision in (None, 'O0'):
        return torch.float32
    return torch.bfloat16
