"""Command line of the PyTorch port:

    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 1 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 2 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch train --stage 3 --epochs N --dataset cityscapes --experiment-id X
    python -m dualsuperreslearningforsemseg_tpu_torch resume-train --checkpoint C --dataset cityscapes
    python -m dualsuperreslearningforsemseg_tpu_torch config-train --file train_stage1_cmdline.json
    python -m dualsuperreslearningforsemseg_tpu_torch benchmark --weights W --dataset cityscapes val
    python -m dualsuperreslearningforsemseg_tpu_torch test --image-file IMG --weights W
    python -m dualsuperreslearningforsemseg_tpu_torch test --dataset cityscapes val 0 --weights W --no-interactive
    python -m dualsuperreslearningforsemseg_tpu_torch compile-model --weights W --output-file M.pt2
    python -m dualsuperreslearningforsemseg_tpu_torch test --images-dir D --weights M.pt2 --compiled-model
    python -m dualsuperreslearningforsemseg_tpu_torch prune-weights --src-weights W --dest-weights P.weights
    python -m dualsuperreslearningforsemseg_tpu_torch print-model --stage 3
    python -m dualsuperreslearningforsemseg_tpu_torch inspect-checkpoint --checkpoint C
    python -m dualsuperreslearningforsemseg_tpu_torch edit-checkpoint --checkpoint C --key K --value V --typeof int
    python -m dualsuperreslearningforsemseg_tpu_torch purge-weights-logs --all --yes

The subcommands are ``main.py``'s (reference main.py:112-208), with the
same arguments and checks, and ``cuda`` (the default) and ``cpu`` as the
devices.  ``train`` runs stages 1, 2 and 3; stage k >= 2 warm-starts from
stage k-1's ``final.weights`` in the same experiment, so an existing
experiment directory is taken at stages 2 and 3 (the JAX CLI refuses any
existing one, so its cascade finds no earlier stage inside an experiment).
``resume-train`` takes every setting from the checkpoint (main.py:76-80
there), its device mapped by ``settings.port_device``: a JAX-era
checkpoint of ``tpu`` resumes on the card.  ``config-train`` turns each key
of a JSON file into ``--key value`` of a ``train`` run in a spawned child
process, the device mapped alike, and exits with the child's code.
``train`` and ``resume-train`` tee their output to
``<experiment>/logs/stage{k}/train/stdout.txt``; the other commands print
through the same ``tqdm``-safe override without a log file.  ``--profile``
(``train``, ``test``) runs the command under ``torch.profiler`` and writes
a Chrome trace into ``outputs/profile``: ``profiling.json``, or under
``--distributed`` one ``profiling_rank{r}.json`` for each rank r; the
trace carries the program's spans (utils/spans.py: ``data.warp``,
``train.forward``, ``test.readback`` ...) as named host ranges.  ``compile-model`` writes a
``torch.export`` program (``.pt2``), not the JAX package's StableHLO, and
takes ``--device`` (the JAX command exports for its environment's
backend).  ``purge-weights-logs`` deletes ``weights/stage{k}`` and
``logs/stage{k}`` under the working directory and exits 0.

``train`` and ``resume-train`` take ``--distributed MASTER_ADDR MASTER_PORT
NODES DEVICES_PER_NODE BACKEND INIT_METHOD NODE_ID`` (main.py:135,168
there; the tuple as utils/validators.py parses it): this process checks
every argument once, then spawns ``DEVICES_PER_NODE`` ranks, each running
the command on ``cuda:local_rank`` (or the CPU) in the process group of
``NODES * DEVICES_PER_NODE`` ranks (parallel/mesh.py), and exits non-zero
when any rank fails.  A backend the device cannot serve, and more ranks per
node than visible cards, exit with code 2 before any work.  Only rank 0
tees ``stdout.txt``; with ``--profile`` every rank writes its trace.
"""

import argparse
import importlib
import json
import multiprocessing
import os.path
import shutil
import sys

from . import settings
from .utils import (CAUTION, FATAL, INFO, INVALID_FILENAME_CHARS, OverridePrintWithTQDMWriteAndLog,
                    hasExtension, isInvalidFilename, ValidateDatasetNameAndSplit,
                    ValidateDatasetNameSplitAndIndex, ValidateDistributedTrainingOptions)

# options of main.py that the port does not have yet: none since --distributed
_NOT_PORTED = ()
_DISTRIBUTED_METAVAR = ('MASTER_ADDR', 'MASTER_PORT', 'NODES', 'DEVICES_PER_NODE', 'BACKEND',
                        'INIT_METHOD', 'NODE_ID')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='python -m dualsuperreslearningforsemseg_tpu_torch',
        description="PyTorch/CUDA implementation of 'Dual Super Resolution Learning For Semantic Segmentation', CVPR 2020 paper.")
    commands = parser.add_subparsers(title='commands', dest='command', required=True)

    train_parser = commands.add_parser('train', help="Train a stage of the DSRL model")
    train_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model trains on (cuda or cpu)")
    train_parser.add_argument('--distributed', required=False, nargs=7, metavar=_DISTRIBUTED_METAVAR, const=settings.SUPPORTED_DISTRIBUTED_BACKENDS, action=ValidateDistributedTrainingOptions, help="Multi-process training: one process per device, NODES x DEVICES_PER_NODE ranks (gloo, nccl or mpi; xla maps to the device's default)")
    train_parser.add_argument('--mixed-precision', default=settings.DEFAULT_AMP_OPTIMIZATION_OPTION, type=str.upper, choices=[x for x in settings.AMP_OPTIMIZATION_OPTIONS if x], help="bf16 autocast with float32 parameters; apex opt-level strings (O0-O3) are accepted and mapped")
    train_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    train_parser.add_argument('--profile', action='store_true', help="Profile the run with torch.profiler (a Chrome trace under outputs/profile, with the program's spans)")
    train_parser.add_argument('--num-workers', default=settings.DEFAULT_NUM_WORKERS, type=int, help="Worker processes decoding input batches")
    train_parser.add_argument('--dataset', required=True, type=str.casefold, choices=settings.DATASETS.keys(), help="Registered dataset to train on")
    train_parser.add_argument('--val-interval', default=settings.DEFAULT_VAL_INTERVAL, type=int, help="Run validation every N epochs")
    train_parser.add_argument('--checkpoint-interval', default=settings.DEFAULT_CHECKPOINT_INTERVAL, type=int, help="Autosave a full checkpoint every N epochs")
    train_parser.add_argument('--checkpoint-history', default=settings.DEFAULT_CHECKPOINT_HISTORY, type=int, help="How many autosaved checkpoints to retain (older ones are pruned); 0 disables autosaving")
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
    train_parser.add_argument('--experiment-id', type=str, default='', help="Name for this run; weights and logs land under experiments/<id>/")
    train_parser.add_argument('--description', type=str, default=None, help="Free-text note recorded in the run's params.txt")
    train_parser.add_argument('--early-stopping', action='store_true', help="Stop the run once average training loss drops below average validation loss")
    train_parser.add_argument('--dry-run', action='store_true', help="Skip the network entirely (random outputs) to exercise the engine around it")
    train_parser.add_argument('--debug-nans', action='store_true', help="Raise at the first non-finite loss, and run backward under autograd's anomaly detection")
    train_parser.add_argument('--yes', action='store_true', help="Assume 'yes' for interactive confirmations (non-interactive runs)")

    config_train_parser = commands.add_parser('config-train', help="Launch 'train' with options taken from a JSON config file")
    config_train_parser.add_argument('--file', required=True, type=str, help="JSON file whose keys/values become 'train' command-line options")

    resume_train_parser = commands.add_parser('resume-train', help="Continue an interrupted run from its autosaved checkpoint")
    resume_train_parser.add_argument('--checkpoint', required=True, type=str, help="The .checkpoint file to continue training from (hyperparameters come from it)")
    resume_train_parser.add_argument('--distributed', required=False, nargs=7, metavar=_DISTRIBUTED_METAVAR, const=settings.SUPPORTED_DISTRIBUTED_BACKENDS, action=ValidateDistributedTrainingOptions, help="Multi-process training: one process per device, NODES x DEVICES_PER_NODE ranks (gloo, nccl or mpi; xla maps to the device's default)")
    resume_train_parser.add_argument('--dataset', required=True, type=str.casefold, choices=settings.DATASETS.keys(), help="Registered dataset to train on")

    test_parser = commands.add_parser('test', help="Run inference and save colorized segmentation visualizations")
    test_source = test_parser.add_mutually_exclusive_group(required=True)
    test_source.add_argument('--image-file', type=str, help="Segment a single image file")
    test_source.add_argument('--images-dir', type=str, help="Segment every JPG/PNG in a directory")
    test_source.add_argument('--dataset', nargs=3, metavar=('DATASET', 'SPLIT', 'STARTING_INDEX'), const=settings.DATASETS, action=ValidateDatasetNameSplitAndIndex, help="Walk a dataset split, starting at the given index")
    test_parser.add_argument('--output-dir', type=str, default=settings.OUTPUTS_DIR, help="Where to write the visualization PNGs")
    test_parser.add_argument('--weights', required=True, type=str, help="Trained .checkpoint/.weights file (or the program compile-model wrote, with --compiled-model)")
    test_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model runs on (cuda or cpu)")
    test_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    test_parser.add_argument('--profile', action='store_true', help="Profile the run with torch.profiler (a Chrome trace under outputs/profile, with the program's spans)")
    test_parser.add_argument('--compiled-model', action='store_true', help="Treat --weights as the .pt2 program produced by compile-model")
    test_parser.add_argument('--show', action='store_true', help="Open each visualization in the system image viewer after saving it")
    test_parser.add_argument('--no-interactive', action='store_true', help="In dataset mode, do not pause for ENTER between images")

    purge_parser = commands.add_parser('purge-weights-logs', help="Delete saved weights and logs for one stage or all stages")
    purge_type = purge_parser.add_mutually_exclusive_group(required=True)
    purge_type.add_argument('--stage', type=int, choices=settings.STAGES, help="Only purge this stage")
    purge_type.add_argument('--all', action='store_true', help="Purge every stage")
    purge_parser.add_argument('--yes', action='store_true', help="Assume 'yes' for the confirmation prompt")

    print_model_parser = commands.add_parser('print-model', help="Show the model's layers and parameter counts for a stage")
    print_model_parser.add_argument('--stage', required=True, type=int, choices=settings.STAGES, help="Stage whose model is built")
    print_model_parser.add_argument('--dataset', type=str.casefold, choices=settings.DATASETS.keys(), default=list(settings.DATASETS.keys())[0], help="Dataset whose class count applies")

    # Both the reference's misspelled public command name and the correct one.
    for prune_cmd in ['purne-weights', 'prune-weights']:
        prune_parser = commands.add_parser(prune_cmd, help="Strip training-only parameters (SISR/FA branches, optimizer state) for deployment")
        prune_parser.add_argument('--src-weights', required=True, type=str, help="Input .checkpoint/.weights file")
        prune_parser.add_argument('--dest-weights', required=True, type=str, help="Output inference .weights file")
        prune_parser.add_argument('--dataset', type=str.casefold, choices=settings.DATASETS.keys(), default=list(settings.DATASETS.keys())[0], help="Dataset whose class count applies")
        prune_parser.add_argument('--torch-format', action='store_true', help="Write a .pth state dict with torch.save instead")
        prune_parser.add_argument('--yes', action='store_true', help="Assume 'yes' for overwrite confirmation")

    inspect_parser = commands.add_parser('inspect-checkpoint', help="Print a checkpoint's hyperparameters and bookkeeping")
    inspect_parser.add_argument('--checkpoint', required=True, type=str, help="The .checkpoint file to inspect")

    edit_parser = commands.add_parser('edit-checkpoint', help="Overwrite one key in a checkpoint file")
    edit_parser.add_argument('--checkpoint', required=True, type=str, help="The .checkpoint file to modify")
    edit_parser.add_argument('--key', required=True, type=str, help="Checkpoint dictionary key to set")
    edit_parser.add_argument('--value', required=True, type=str, help="New value (parsed as --typeof)")
    edit_parser.add_argument('--typeof', required=True, type=str, help="Python type name the value is coerced to (str/int/float/bool)")

    benchmark_parser = commands.add_parser('benchmark', help="Evaluate weights over a dataset split (CE, mIoU, accuracy, throughput)")
    benchmark_parser.add_argument('--weights', required=True, type=str, help="Trained .checkpoint/.weights file")
    benchmark_parser.add_argument('--dataset', required=True, nargs=2, metavar=('DATASET', 'SPLIT'), action=ValidateDatasetNameAndSplit, const=settings.DATASETS, help="Dataset name and split to evaluate")
    benchmark_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the model runs on (cuda or cpu)")
    benchmark_parser.add_argument('--disable-cudnn-benchmark', action='store_true', help="Do not let cuDNN time its convolution algorithms")
    benchmark_parser.add_argument('--num-workers', default=settings.DEFAULT_NUM_WORKERS, type=int, help="Worker processes decoding input batches")
    benchmark_parser.add_argument('--batch-size', default=settings.DEFAULT_BATCH_SIZE, type=int, help="Samples per evaluation step")

    compile_parser = commands.add_parser('compile-model', help="Export the stage-1 model as a torch.export program (.pt2) for deployment")
    compile_parser.add_argument('--weights', required=True, type=str, help="Trained .checkpoint/.weights file")
    compile_parser.add_argument('--output-file', required=True, type=str, help="Where the exported program is written")
    compile_parser.add_argument('--dataset', type=str.casefold, choices=settings.DATASETS.keys(), default=list(settings.DATASETS.keys())[0], help="Dataset whose class count applies")
    compile_parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold, choices=settings.SUPPORTED_DEVICES, help="Device the program is exported for (cuda or cpu)")
    return parser


_WEIGHTS_EXTENSIONS = ('.checkpoint', '.weights')


def _check_file(path, flag, extensions=_WEIGHTS_EXTENSIONS, noun='weights file'):
    """``flag``'s file must exist and, where ``extensions`` are given, have
    one of them (main.py's messages)."""
    if extensions and not any(hasExtension(path, x) for x in extensions):
        raise argparse.ArgumentTypeError("{} expects a {} file.".format(flag, ' or '.join(extensions)))
    if not os.path.isfile(path):
        raise argparse.ArgumentTypeError("No such {}: '{}'.".format(noun, path))


def _validate_distributed(distributed, device):
    """``--distributed`` on ``device`` (the CLI's device name): the backend
    must serve the device, and ``cuda`` needs a visible card for each of
    the node's ranks (no two ranks share one)."""
    from .parallel import distributed_init_kwargs
    try:
        distributed_init_kwargs(distributed, 0, device)
    except ValueError as ex:
        raise argparse.ArgumentTypeError(str(ex))
    if device == 'cuda':
        import torch
        visible = torch.cuda.device_count()
        if distributed['DEVICES_PER_NODE'] > visible:
            raise argparse.ArgumentTypeError(
                "DEVICES_PER_NODE={} needs as many CUDA cards, and torch sees {}.".format(
                    distributed['DEVICES_PER_NODE'], visible))


def _validate_train(args):
    """Post-parse checks of ``train`` (parity: main.py:229-268).  May clear
    an earlier run of the same stage after confirmation, as main.py does."""
    if not args.num_workers >= 0:
        raise argparse.ArgumentTypeError("--num-workers must be >= 0.")
    if not args.val_interval > 0:
        raise argparse.ArgumentTypeError("--val-interval must be a positive number of epochs.")
    if not args.checkpoint_interval > 0:
        raise argparse.ArgumentTypeError("--checkpoint-interval must be a positive number of epochs.")
    if not args.checkpoint_history >= 0:
        raise argparse.ArgumentTypeError("--checkpoint-history must be >= 0 (0 disables autosaving).")
    if args.init_weights:
        _check_file(args.init_weights, '--init-weights')
        args.init_weights = os.path.abspath(args.init_weights)
    if not args.batch_size > 0:
        raise argparse.ArgumentTypeError("--batch-size must be a positive integer.")
    if not args.epochs > 0:
        raise argparse.ArgumentTypeError("--epochs must be a positive integer.")
    for name, flag in (('learning_rate', '--learning-rate'), ('momentum', '--momentum'),
                       ('weights_decay', '--weights-decay'), ('poly_power', '--poly-power')):
        if not getattr(args, name) > 0.:
            raise argparse.ArgumentTypeError("{} must be > 0.".format(flag))
    if args.distributed:
        _validate_distributed(args.distributed, args.device)
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


def _validate_resume(args):
    """Post-parse checks of ``resume-train`` (parity: main.py:293-305)."""
    if not hasExtension(args.checkpoint, '.checkpoint'):
        raise argparse.ArgumentTypeError("resume-train needs a full .checkpoint file (model + optimizer + engine state), not a .weights file.")
    if not os.path.isfile(args.checkpoint):
        raise argparse.ArgumentTypeError("No such checkpoint file: '{}'.".format(args.checkpoint))


def _config_train_argv(filename):
    """``config-train``'s ``train`` arguments (parity: main.py:270-283):
    each top-level JSON key and value becomes ``--key value``, the device
    mapped to the port's (``settings.port_device``)."""
    if not os.path.isfile(filename):
        raise argparse.ArgumentTypeError("No such config file: '{}'.".format(filename))
    try:
        with open(filename) as config_file:
            config = json.load(config_file)
    except json.JSONDecodeError as ex:
        raise argparse.ArgumentTypeError("'{}' is not valid JSON: {}".format(filename, ex))
    argv = ['train']
    for key, value in config.items():
        if key == 'device':
            try:
                value = settings.port_device(value)
            except ValueError as ex:
                raise argparse.ArgumentTypeError(str(ex))
        # A list (the 7 values of "distributed") gives one argument each.
        argv += ['--' + key] + [str(v) for v in (value if isinstance(value, list) else [value])]
    return argv


def _validate(args):
    """Post-parse checks (parity: main.py:229-360); raises
    argparse.ArgumentTypeError with the JAX CLI's messages."""
    if args.command == 'train':
        return _validate_train(args)
    if args.command == 'resume-train':
        return _validate_resume(args)
    if args.command == 'config-train':
        args.train_argv = _config_train_argv(args.file)
    elif args.command == 'test':
        if args.image_file and not os.path.isfile(args.image_file):
            raise argparse.ArgumentTypeError("No such image file: '{}'.".format(args.image_file))
        if args.images_dir and not os.path.isdir(args.images_dir):
            raise argparse.ArgumentTypeError("No such directory: '{}'.".format(args.images_dir))
        # A compiled program may have any name (main.py:307-316).
        _check_file(args.weights, '--weights', () if args.compiled_model else _WEIGHTS_EXTENSIONS)
    elif args.command in ('purne-weights', 'prune-weights'):
        _check_file(args.src_weights, '--src-weights')
        if os.path.isfile(args.dest_weights):
            answer = 'y' if args.yes else input(CAUTION("Destination weights file specified already exists. This will overwrite the file. Continue (y/n)? ")).casefold()
            if answer != 'y':
                sys.exit(0)
    elif args.command in ('inspect-checkpoint', 'edit-checkpoint'):
        _check_file(args.checkpoint, '--checkpoint', ('.checkpoint',), 'checkpoint file')
    elif args.command in ('benchmark', 'compile-model'):
        _check_file(args.weights, '--weights')
    if args.command == 'benchmark':
        if not args.num_workers >= 0:
            raise argparse.ArgumentTypeError("--num-workers must be >= 0.")
        if not args.batch_size > 0:
            raise argparse.ArgumentTypeError("--batch-size must be a positive integer.")


def _purge_weights_logs(args):
    """``purge-weights-logs`` (parity: main.py:317-328): after confirmation,
    delete ``logs/stage{k}`` and ``weights/stage{k}`` under the working
    directory for the stage, or for every stage with ``--all``."""
    answer = 'y' if args.yes else input('This will delete {:s} logs and weights. Continue? (y/n) '.format('all' if args.all else 'stage {:d}'.format(args.stage))).casefold()
    if answer != 'y':
        return
    for stage in (settings.STAGES if args.all else [args.stage]):
        for dir_ in (settings.LOGS_DIR.format(stage=stage, mode=''),
                     settings.WEIGHTS_DIR.format(stage=stage)):
            if os.path.isdir(dir_):
                shutil.rmtree(dir_)


def _spawnable(fn):
    """``fn`` as an attribute of this module imported by its package name:
    run as ``python -m``, this file is ``__main__``, and a spawned process
    cannot find the functions of a package's ``__main__`` under that name."""
    return getattr(importlib.import_module(__spec__.name if __spec__ else __name__), fn.__name__)


def _config_train_child(argv):
    """The ``train`` run of ``config-train``, in the spawned child."""
    main(argv)


def _global_rank(kwargs):
    """This process's rank in the process group (0 without one)."""
    if not kwargs.get('distributed'):
        return 0
    from .parallel import distributed_init_kwargs
    return distributed_init_kwargs(kwargs['distributed'], kwargs['local_rank'],
                                   kwargs['device'])[0]['rank']


def _train_or_resume(kwargs):
    """``train`` and ``resume-train`` with their output teed to the stage's
    ``stdout.txt`` (parity: main.py:94-107), by the master rank only."""
    from . import commands
    master = _global_rank(kwargs) == 0
    logs_dir = os.path.join(kwargs['experiment_id'],
                            settings.LOGS_DIR.format(stage=kwargs['stage'], mode='train'))
    if master:
        os.makedirs(logs_dir, exist_ok=True)
    with OverridePrintWithTQDMWriteAndLog(os.path.join(logs_dir, settings.STDOUT_FILE),
                                          master=master) as stdout:
        try:
            return commands.train_or_resume(
                is_resuming_training=kwargs['command'] == 'resume-train', **kwargs)
        except KeyboardInterrupt:
            stdout.write("Caught Ctrl+c to interrupt training!")
            raise
        except Exception as ex:
            stdout.write("Exception caught: {}".format(str(ex)))
            raise


def _run(kwargs):
    if kwargs['command'] in ('train', 'resume-train'):
        return _train_or_resume(kwargs)
    from . import commands
    name = 'prune_weights' if kwargs['command'] == 'purne-weights' else kwargs['command']
    with OverridePrintWithTQDMWriteAndLog():
        return getattr(commands, name.replace('-', '_'))(**kwargs)


def _run_profiled(kwargs):
    """``_run``, under ``torch.profiler`` with ``--profile``, on every rank
    as the JAX CLI traces every process (main.py:364-366): one process
    writes ``PROFILING_FILE``, rank r of ``--distributed`` training
    ``PROFILING_RANK_FILE``, both under ``PROFILING_DIR``.  Every span the
    program opens meanwhile (utils/spans.py) shows in the trace as a
    ``record_function`` range of its name."""
    if kwargs.get('dataset'):
        # NAME (split 'train'), [NAME, SPLIT] or [NAME, SPLIT, START_INDEX]
        # -> the registry entry (parity: main.py:58-70).
        name, split, *start = ([kwargs['dataset'], 'train'] if isinstance(kwargs['dataset'], str)
                               else kwargs['dataset'])
        kwargs = dict(kwargs, dataset=dict(settings.DATASETS[name], name=name, split=split,
                                           starting_index=start[0] if start else 0))
    if not kwargs.get('profile'):
        return _run(kwargs)
    from torch.profiler import ProfilerActivity, profile
    rank = _global_rank(kwargs)
    os.makedirs(settings.PROFILING_DIR, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = _run(kwargs)
    prof.export_chrome_trace(os.path.join(settings.PROFILING_DIR, settings.PROFILING_RANK_FILE.format(
        rank=rank) if kwargs.get('distributed') else settings.PROFILING_FILE))
    if rank == 0:
        print(INFO("Profiling output has been saved to '{:s}'.".format(settings.PROFILING_DIR)))
    return result


def _rank_main(local_rank, kwargs):
    """One spawned rank of ``--distributed`` training."""
    _run_profiled(dict(kwargs, local_rank=local_rank))


def main(argv=None):
    """Parses ``argv`` (default: ``sys.argv[1:]``) and runs the command;
    returns what the command returns (None for ``--distributed`` training,
    whose ranks run in spawned processes).  Invalid arguments exit with
    code 2; ``config-train`` exits with its child's code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        _validate(args)
    except argparse.ArgumentTypeError as ex:
        print(FATAL(str(ex)))
        parser.print_usage()
        sys.exit(2)
    if args.command == 'purge-weights-logs':
        _purge_weights_logs(args)
        sys.exit(0)
    if args.command == 'config-train':
        child = multiprocessing.get_context('spawn').Process(target=_spawnable(_config_train_child),
                                                             args=(args.train_argv,))
        try:
            child.start()
            child.join()
        except KeyboardInterrupt:
            sys.exit(0)
        sys.exit(child.exitcode)
    kwargs = vars(args)
    if args.command == 'resume-train':
        from .checkpoint import load_checkpoint_or_weights
        checkpoint = load_checkpoint_or_weights(args.checkpoint)
        for variable in settings.VARIABLES_IN_CHECKPOINT:
            kwargs[variable] = checkpoint[variable]
        kwargs['device'] = settings.port_device(kwargs['device'])
        if args.distributed:
            try:
                _validate_distributed(args.distributed, kwargs['device'])
            except argparse.ArgumentTypeError as ex:
                print(FATAL(str(ex)))
                parser.print_usage()
                sys.exit(2)
    if kwargs.get('distributed'):
        from .parallel import spawn_ranks
        spawn_ranks(_spawnable(_rank_main), kwargs['distributed']['DEVICES_PER_NODE'], (kwargs,))
        return None
    return _run_profiled(kwargs)


if __name__ == '__main__':
    main()
