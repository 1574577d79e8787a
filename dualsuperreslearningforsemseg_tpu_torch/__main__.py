"""Command line of the PyTorch port:

    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 1 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 2 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 3 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch benchmark --weights W --dataset cityscapes val
    python -m dualsuperreslearningforsemseg_tpu_torch test --image-file IMG --weights W

The ``train``, ``benchmark`` and ``test`` subcommands take the arguments of
``main.py``'s (reference main.py:112-208), with ``cuda`` (the default) and
``cpu`` as the devices.  ``train`` runs stages 1, 2 and 3; stage k >= 2
warm-starts from stage k-1's ``final.weights`` in the same experiment, so
an existing experiment directory is taken at stages 2 and 3 (the JAX CLI
refuses any existing one, so its cascade finds no earlier stage inside an
experiment).  The options ``train`` does not port yet
(``--early-stopping``, ``--distributed``, ``--profile``, ``--dry-run``,
``--debug-nans``) exit with an error naming the ROADMAP queue.  ``test``'s
dataset mode and ``--compiled-model`` are not ported yet.
"""

import argparse
import os.path
import shutil
import sys

from . import settings
from .utils import (CAUTION, FATAL, INVALID_FILENAME_CHARS, hasExtension, isInvalidFilename,
                    ValidateDatasetNameAndSplit)

# train options of main.py that the port does not have yet (ROADMAP.md queue 3)
_NOT_PORTED = ('early_stopping', 'distributed', 'profile', 'dry_run', 'debug_nans')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m dualsuperreslearningforsemseg_tpu_torch',
        description="PyTorch/CUDA implementation of 'Dual Super Resolution Learning For Semantic Segmentation', CVPR 2020 paper.")
    commands = parser.add_subparsers(title='commands', dest='command', required=True)

    train_parser = commands.add_parser('train', help="Train a stage of the DSRL model")
    train_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model trains on (cuda or cpu)")
    train_parser.add_argument('--distributed', required=False, nargs=7, metavar=('MASTER_ADDR', 'MASTER_PORT', 'NODES', 'DEVICES_PER_NODE', 'BACKEND', 'INIT_METHOD', 'NODE_ID'), help="Multi-process training topology (not ported yet)")
    train_parser.add_argument('--mixed-precision', default=settings.DEFAULT_AMP_OPTIMIZATION_OPTION, type=str.upper, choices=[x for x in settings.AMP_OPTIMIZATION_OPTIONS if x], help="bf16 autocast with float32 parameters; apex opt-level strings (O0-O3) are accepted and mapped")
    train_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    train_parser.add_argument('--profile', action='store_true', help="Profile the run (not ported yet)")
    train_parser.add_argument('--num-workers', default=settings.DEFAULT_NUM_WORKERS, type=int, help="Worker processes decoding input batches")
    train_parser.add_argument('--dataset', required=True, type=str.casefold, choices=settings.DATASETS.keys(), help="Registered dataset to train on")
    train_parser.add_argument('--val-interval', default=settings.DEFAULT_VAL_INTERVAL, type=int, help="Run validation every N epochs")
    train_parser.add_argument('--checkpoint-interval', default=settings.DEFAULT_CHECKPOINT_INTERVAL, type=int, help="Autosave a full checkpoint every N epochs (checkpoints are not ported yet)")
    train_parser.add_argument('--checkpoint-history', default=settings.DEFAULT_CHECKPOINT_HISTORY, type=int, help="How many autosaved checkpoints to retain (checkpoints are not ported yet)")
    train_parser.add_argument('--init-weights', default=None, type=str, help="Warm-start the model from this .checkpoint/.weights file")
    train_parser.add_argument('--batch-size', default=settings.DEFAULT_BATCH_SIZE, type=int, help="Samples per step")
    train_parser.add_argument('--epochs', required=True, type=int, help="Total epochs to train for")
    train_parser.add_argument('--learning-rate', type=float, default=settings.DEFAULT_LEARNING_RATE, help="Initial SGD learning rate (poly-decayed per epoch)")
    train_parser.add_argument('--end-learning-rate', type=float, default=settings.DEFAULT_END_LEARNING_RATE, help="Learning rate floor reached at the final epoch")
    train_parser.add_argument('--momentum', type=float, default=settings.DEFAULT_MOMENTUM, help="SGD momentum coefficient")
    train_parser.add_argument('--weights-decay', type=float, default=settings.DEFAULT_WEIGHTS_DECAY, help="SGD weight decay (L2)")
    train_parser.add_argument('--poly-power', type=float, default=settings.DEFAULT_POLY_POWER, help="Exponent of the polynomial decay schedule")
    train_parser.add_argument('--stage', required=True, type=int, choices=settings.STAGES, help="Training stage: 1 = segmentation only, 2 = + SISR branch (MSE), 3 = + feature affinity (FA)")
    train_parser.add_argument('--w1', type=float, default=settings.DEFAULT_LOSS_WEIGHTS[0], help="SISR MSE loss weight (stage >= 2)")
    train_parser.add_argument('--w2', type=float, default=settings.DEFAULT_LOSS_WEIGHTS[1], help="Feature-affinity loss weight (stage 3)")
    train_parser.add_argument('--freeze-batch-norm', action='store_true', help="Use running statistics in every BatchNorm during training (no stat updates)")
    train_parser.add_argument('--experiment-id', type=str, default='', help="Name for this run; weights land under experiments/<id>/")
    train_parser.add_argument('--description', type=str, default=None, help="Free-text note about the run")
    train_parser.add_argument('--early-stopping', action='store_true', help="Stop once average training loss drops below average validation loss (not ported yet)")
    train_parser.add_argument('--dry-run', action='store_true', help="Skip the network entirely (not ported yet)")
    train_parser.add_argument('--debug-nans', action='store_true', help="Raise on the first NaN (not ported yet)")
    train_parser.add_argument('--yes', action='store_true', help="Assume 'yes' for interactive confirmations (non-interactive runs)")

    test_parser = commands.add_parser('test', help="Run inference and save colorized segmentation visualizations")
    test_source = test_parser.add_mutually_exclusive_group(required=True)
    test_source.add_argument('--image-file', type=str, help="Segment a single image file")
    test_source.add_argument('--images-dir', type=str, help="Segment every JPG/PNG in a directory")
    test_parser.add_argument('--output-dir', type=str, default=settings.OUTPUTS_DIR, help="Where to write the visualization PNGs")
    test_parser.add_argument('--weights', required=True, type=str, help="Trained .checkpoint/.weights file")
    test_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model runs on (cuda or cpu)")
    test_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    test_parser.add_argument('--show', action='store_true', help="Open the visualization in the system image viewer after saving it")

    benchmark_parser = commands.add_parser('benchmark', help="Evaluate weights over a dataset split (CE, mIoU, accuracy, throughput)")
    benchmark_parser.add_argument('--weights', required=True, type=str, help="Trained .checkpoint/.weights file")
    benchmark_parser.add_argument('--dataset', required=True, nargs=2, metavar=('DATASET', 'SPLIT'), action=ValidateDatasetNameAndSplit, const=settings.DATASETS, help="Dataset name and split to evaluate")
    benchmark_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model runs on (cuda or cpu)")
    benchmark_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    benchmark_parser.add_argument('--num-workers', default=settings.DEFAULT_NUM_WORKERS, type=int, help="Worker processes decoding input batches")
    benchmark_parser.add_argument('--batch-size', default=settings.DEFAULT_BATCH_SIZE, type=int, help="Samples per evaluation step")
    return parser


def _validate_train(args):
    """Post-parse checks of ``train`` (parity: main.py:229-268), then the
    options the port does not have yet.  May clear an earlier run of the
    same stage after confirmation, as main.py does."""
    if not args.num_workers >= 0:
        raise argparse.ArgumentTypeError("--num-workers must be >= 0.")
    if not args.val_interval > 0:
        raise argparse.ArgumentTypeError("--val-interval must be a positive number of epochs.")
    if not args.checkpoint_interval > 0:
        raise argparse.ArgumentTypeError("--checkpoint-interval must be a positive number of epochs.")
    if not args.checkpoint_history >= 0:
        raise argparse.ArgumentTypeError("--checkpoint-history must be >= 0 (0 disables autosaving).")
    if args.init_weights:
        if not any(hasExtension(args.init_weights, x) for x in ['.checkpoint', '.weights']):
            raise argparse.ArgumentTypeError("--init-weights expects a .checkpoint or .weights file.")
        if not os.path.isfile(args.init_weights):
            raise argparse.ArgumentTypeError("No such weights file: '{}'.".format(args.init_weights))
        args.init_weights = os.path.abspath(args.init_weights)
    if not args.batch_size > 0:
        raise argparse.ArgumentTypeError("--batch-size must be a positive integer.")
    if not args.epochs > 0:
        raise argparse.ArgumentTypeError("--epochs must be a positive integer.")
    for name, flag in (('learning_rate', '--learning-rate'), ('momentum', '--momentum'),
                       ('weights_decay', '--weights-decay'), ('poly_power', '--poly-power')):
        if not getattr(args, name) > 0.:
            raise argparse.ArgumentTypeError("{} must be > 0.".format(flag))
    for name in _NOT_PORTED:
        if getattr(args, name):
            raise argparse.ArgumentTypeError("--{} is not ported yet (ROADMAP.md queue 3).".format(
                name.replace('_', '-')))
    if args.experiment_id:
        if isInvalidFilename(args.experiment_id):
            raise argparse.ArgumentTypeError("--experiment-id may not contain any of: {}.".format(
                ', '.join(INVALID_FILENAME_CHARS)))
        args.experiment_id = os.path.join(settings.EXPERIMENTS_ROOT_DIR, args.experiment_id)
        if args.stage == 1 and os.path.isdir(args.experiment_id):
            raise argparse.ArgumentTypeError("An experiment named '{}' already exists; pick a new id (experiment directories are never overwritten).".format(os.path.basename(args.experiment_id)))
    weights_dir = os.path.join(args.experiment_id, settings.WEIGHTS_DIR.format(stage=args.stage))
    if os.path.isfile(os.path.join(weights_dir, settings.FINAL_WEIGHTS_FILE)):
        answer = 'y' if args.yes else input(CAUTION("Weights file for this stage already exists. Training will delete the current weights and logs. Continue? (y/n) ")).casefold()
        if answer != 'y':
            sys.exit(0)
        shutil.rmtree(os.path.join(args.experiment_id, settings.LOGS_DIR.format(stage=args.stage, mode='')), ignore_errors=True)
        shutil.rmtree(weights_dir)


def _validate(args):
    """Post-parse checks (parity: main.py:229-354); raises
    argparse.ArgumentTypeError with the JAX CLI's messages."""
    if args.command == 'train':
        return _validate_train(args)
    if not any(hasExtension(args.weights, x) for x in ['.checkpoint', '.weights']):
        raise argparse.ArgumentTypeError("--weights expects a .checkpoint or .weights file.")
    if not os.path.isfile(args.weights):
        raise argparse.ArgumentTypeError("No such weights file: '{}'.".format(args.weights))
    if args.command == 'test':
        if args.image_file and not os.path.isfile(args.image_file):
            raise argparse.ArgumentTypeError("No such image file: '{}'.".format(args.image_file))
        if args.images_dir and not os.path.isdir(args.images_dir):
            raise argparse.ArgumentTypeError("No such directory: '{}'.".format(args.images_dir))
    else:
        if not args.num_workers >= 0:
            raise argparse.ArgumentTypeError("--num-workers must be >= 0.")
        if not args.batch_size > 0:
            raise argparse.ArgumentTypeError("--batch-size must be a positive integer.")


def main(argv=None):
    """Parses ``argv`` (default: ``sys.argv[1:]``) and runs the command;
    returns what the command returns.  Invalid arguments exit with code 2."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        _validate(args)
    except argparse.ArgumentTypeError as ex:
        print(FATAL(str(ex)))
        parser.print_usage()
        sys.exit(2)
    kwargs = vars(args)
    if args.command == 'benchmark':
        name, split = args.dataset
        kwargs['dataset'] = dict(settings.DATASETS[name], name=name, split=split)
    elif args.command == 'train':
        kwargs['dataset'] = dict(settings.DATASETS[args.dataset], name=args.dataset, split='train')
    from . import commands
    return getattr(commands, args.command)(**kwargs)


if __name__ == '__main__':
    main()
