"""`train` and `resume-train`, stages 1 to 3: the JAX package's training
engine (commands/train_or_resume.py:90-778 there) on one device, or on one
rank of a process group (``--distributed``, below).

* Model: ``DSRL(stage=stage)`` with the seeded Kaiming init from
  ``RANDOM_SEED``.  A resume loads the checkpoint's ``model_state_dict``
  with ``strict=True`` and its momentum (train/optim.py, either layout),
  and starts after the checkpoint's ``epoch`` with its
  ``best_validation_dict``.  Otherwise ``--init-weights`` (``strict=False``);
  without it, stage 1 loads the pretrained ResNet-101 backbone when
  ``weights/resnet101_pretrained.pth`` exists (never downloaded), and
  stages 2 and 3 warm-start from the previous stage's
  ``<experiment>/weights/stage{k-1}/final.weights`` (``strict=False``), or,
  where that file is missing, fall back to the pretrained backbone with a
  CAUTION (train_or_resume.py:128-163 there).
* Seeds: ``nn.Dropout`` draws from torch's default generators, seeded with
  ``RANDOM_SEED + 1000 * (starting_epoch + 1)`` (train_or_resume.py:270
  there); the photometric draws from a generator on the device seeded with
  that value plus one.  ``PolynomialLR`` starts at ``last_epoch =
  starting_epoch - 1``, so a resumed epoch has the uninterrupted run's
  learning rate.
* Input: the loaders (data/pipeline.py, data/transforms.py) read each
  batch through the raw pair cache when ``DSRL_TPU_RAW_CACHE`` names a
  directory, and decode the rest with the native batched decode.  Unless
  ``DSRL_TPU_PRIME_RAW_CACHE=0``, a background thread per split fills the
  cache with the rank's shard of the first epoch read, and the val shard,
  while the model is built (train_or_resume.py:237-254 there).  The summary
  keeps each epoch's seconds and the loop's wait on the loader before each
  step.
* Each step: the loader's uint8 batch goes to the device, is warped there
  with the JAX package's matrices for (epoch, batch) (data/augment.py), and
  the train step (train/steps.py) runs K2 (at stages 2-3 emitting the
  unshuffled SISR target too), the forward, K1 forward and backward, the
  MSE and, at stage 3, K4 forward and backward, and SGD.  Losses are read
  one step late, so the host does not wait for the step it just queued.
  ``--dry-run`` and ``--debug-nans``: train/steps.py.
* Each epoch: the averages print as the JAX engine prints them and go to
  the train ``SummaryWriter`` (utils/tb_writer.py) under
  ``<experiment>/logs/stage{k}/train``; every ``--checkpoint-interval``
  epochs (``--checkpoint-history`` > 0) the full state is autosaved as
  ``epoch{N}.checkpoint`` under ``<experiment>/weights/stage{k}/checkpoints``
  and the one ``history * interval`` epochs older is removed.  Validation
  every ``--val-interval`` epochs runs the eval step (K3, and K4 at stage
  3), logs its scalars and one example image to the val writer, replaces
  ``epoch{N}_bestval.checkpoint`` when the mIoU improves, and with
  ``--early-stopping`` ends the run once the average training loss is below
  the validation loss.
* The state leaves the device once per save (parameters, BN buffers and
  momentum: about 457 MiB at stage 3), never inside the step loop.
  ``final.weights`` is written at the end, also after an early stop, and
  ``params.txt`` at the start.
* ``distributed`` (``--distributed``; the CLI spawns one process per
  device, each calling this with its ``local_rank``): the rank joins the
  process group (parallel/mesh.py) and drives ``cuda:local_rank`` (or the
  CPU).  Every rank builds the same seeded model, or loads the same
  checkpoint onto its own device; the train step makes BatchNorm
  cross-rank and wraps the model in ``DistributedDataParallel``
  (train/steps.py).  The loaders serve the rank's shard
  (``--batch-size`` per rank, so the global batch is the JAX package's);
  the dropout seed, the photometric generator and the warp mix the rank in,
  rank 0 keeping the single-process streams.  Validation sums every
  batch's metrics over the ranks, so the losses, mIoU and accuracy are the
  global batch's on every rank, and the best-validation and early-stopping
  decisions are the master's, taken by all ranks together.  Only the
  master writes checkpoints, ``final.weights``, ``params.txt``, the
  TensorBoard logs and ``stdout.txt``, from the unwrapped model; all ranks
  meet at a barrier before they leave.  With ``DSRL_TPU_DEBUG_PARAM_DIGEST``
  set every rank prints ``PARAM_DIGEST rank=R epoch=E <sha256>`` of its
  final parameters (train_or_resume.py:476-495 there).
"""

import glob
import hashlib
import os
import os.path
from datetime import datetime

import numpy as np
import torch

from .. import parallel, settings
from ..checkpoint import load_checkpoint_or_weights, save_checkpoint, save_weights
from ..data import (AugmentConfig, make_warp_transform, make_device_post_fn, make_train_loader,
                    make_eval_transform_fn, make_eval_loader, prime_raw_cache)
from ..metrics import mIoU, Accuracy, AverageMeter
from ..metrics.device import eval_batch_tally, eval_batch_results
from ..models import DSRL, PolynomialLR, init_weights as init_model, load_pretrained_backbone, \
    load_state_dict
from ..models.dsrl import SISR_UPSCALE
from ..ops.colorize import make_input_output_visualization
from ..train import make_train_step, make_eval_step, make_sgd, load_optimizer_state_dict, \
    optimizer_state_dict
from ..utils import (INFO, CAUTION, FATAL, ConditionalContextManager, select_device,
                     device_description, makeSecondsPretty, span)
from ..utils.tb_writer import SummaryWriter

LOSS_NAMES = ('CE', 'MSE', 'FA', 'Total')
# The checkpoint entries of the last train and validation averages, in LOSS_NAMES order.
TRAIN_LOSS_KEYS = ('CE_train_avg_loss', 'MSE_train_avg_loss', 'FA_train_avg_loss', 'Avg_train_loss')
VAL_LOSS_KEYS = ('CE_val_avg_loss', 'MSE_val_avg_loss', 'FA_val_avg_loss', 'Avg_val_loss')


def train_or_resume(is_resuming_training, device, mixed_precision, disable_cudnn_benchmark,
                    num_workers, dataset, val_interval, checkpoint_interval, checkpoint_history,
                    init_weights, batch_size, epochs, learning_rate, end_learning_rate, momentum,
                    weights_decay, poly_power, stage, w1, w2, freeze_batch_norm, experiment_id,
                    description=None, early_stopping=False, dry_run=False, debug_nans=False,
                    distributed=None, local_rank=0, **other_args):
    """Trains ``stage`` (from the checkpoint's state when
    ``is_resuming_training``; ``other_args`` then holds its entries) and
    writes its checkpoints and ``final.weights``.  Returns a summary dict:
    steps, per-epoch train losses, the last validation, the epoch the run
    started after, the best validation, the checkpoints written, the
    weights path, the file the model started from, the seconds taken.
    ``distributed`` and ``local_rank``: the module docstring."""
    process_start = datetime.now()
    device_name = device
    device = select_device(device, cudnn_benchmark=not disable_cudnn_benchmark,
                           local_rank=local_rank if distributed and device == 'cuda' else None)
    if distributed:
        parallel.initialize_distributed(distributed, local_rank, device)
    world, rank, master = parallel.world_size(), parallel.rank(), parallel.is_master_rank()
    ds = dataset['settings']
    compute_dtype = settings.mixed_precision_to_dtype(mixed_precision)
    amp_dtype = None if compute_dtype == torch.float32 else compute_dtype

    if is_resuming_training:
        starting_epoch = other_args['epoch']
        best_validation_dict = dict(other_args['best_validation_dict'])
    else:
        starting_epoch = 0
        best_validation_dict = {'epoch': -1, 'best_miou_percent': 0., 'loss': 0.}
    seed = settings.RANDOM_SEED + 1000 * (starting_epoch + 1)
    # The CPU and every CUDA default generator: dropout masks.
    torch.manual_seed(_rank_seed(seed, rank))
    photometric_gen = torch.Generator(device=device).manual_seed(_rank_seed(seed + 1, rank))

    train_set = dataset['class'](dataset['path'], split='train')
    if not dry_run and len(train_set) == 0:
        raise Exception(FATAL("Cityscapes dataset was not found under '{:s}'.".format(dataset['path'])))
    if not dry_run and len(train_set) < batch_size * world:
        raise Exception(FATAL("The train split has {} images, fewer than one batch of {} on each "
                              "of {} rank(s).".format(len(train_set), batch_size, world)))
    val_set = dataset['class'](dataset['path'], split='val')
    train_loader = make_train_loader(train_set, batch_size, num_workers, device,
                                     seed=settings.RANDOM_SEED, world_size=world, rank=rank)
    val_loader = make_eval_loader(val_set, batch_size, num_workers, device, world, rank)
    # With DSRL_TPU_RAW_CACHE set, decode this rank's shard of the first
    # epoch the loop reads, and the val shard, into the raw cache while the
    # model is built and the card warms up (JAX train_or_resume.py:243-254).
    primers = []
    if os.environ.get('DSRL_TPU_PRIME_RAW_CACHE', '1') != '0':
        for loader, split, epoch in ((train_loader, 'train', starting_epoch + 1),
                                     (val_loader, 'val', 0)):
            primer = prime_raw_cache(loader, epoch)
            if primer is not None:
                primers.append(primer)
                _print(INFO("Priming raw pair cache for the '{:s}' split in the background."
                            .format(split)))

    model = init_model(DSRL(num_classes=ds.NUM_CLASSES, stage=stage),
                       torch.Generator().manual_seed(settings.RANDOM_SEED))
    if is_resuming_training:
        load_state_dict(model, other_args['model_state_dict'], strict=True)
        warm_start = other_args.get('checkpoint')
    else:
        warm_start = _initialize(model, init_weights, stage, experiment_id)
    model.to(device)
    optimizer = make_sgd(model, learning_rate, momentum, weights_decay)
    if is_resuming_training:
        load_optimizer_state_dict(optimizer, model, other_args['optimizer_state_dict'],
                                  model_state_dict=other_args['model_state_dict'])
    scheduler = PolynomialLR(learning_rate, max_decay_steps=epochs, end_learning_rate=end_learning_rate,
                             power=poly_power, last_epoch=starting_epoch - 1)

    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD, ignore_label=ds.IGNORE_CLASS_LABEL)
    warp = make_warp_transform(cfg, ds.LABEL_MAPPING_LUT, settings.RANDOM_SEED, rank=rank)
    # The dry run's SISR stand-in has the target's full-resolution shape.
    post_fn = make_device_post_fn(cfg, dtype=compute_dtype,
                                  unshuffle_hi=SISR_UPSCALE if stage > 1 and not dry_run else 0)
    train_step = make_train_step(model, optimizer, stage, w1, w2, ds.IGNORE_CLASS_LABEL,
                                 freeze_batch_norm, post_fn=post_fn, amp_dtype=amp_dtype,
                                 dry_run=dry_run, debug_nans=debug_nans)
    eval_step = make_eval_step(ds.NUM_CLASSES, ds.IGNORE_CLASS_LABEL, stage, w1, w2,
                               amp_dtype=amp_dtype, dry_run=dry_run)
    eval_transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                            ds.MEAN, ds.STD, ds.LABEL_MAPPING_LUT)

    train_logs_dir = os.path.join(experiment_id, settings.LOGS_DIR.format(stage=stage, mode='train'))
    val_logs_dir = os.path.join(experiment_id, settings.LOGS_DIR.format(stage=stage, mode='val'))
    checkpoints_dir = os.path.join(experiment_id, settings.CHECKPOINTS_DIR.format(stage=stage))
    summary = {'steps': 0, 'train_losses': [], 'val': None, 'warm_start': warm_start,
               'starting_epoch': starting_epoch, 'checkpoints': [], 'epochs': []}
    # What a checkpoint holds besides the epoch and the state
    # (VARIABLES_IN_CHECKPOINT); the loss entries follow each epoch.
    record = dict(device=device_name, mixed_precision=mixed_precision, amp_state_dict=None,
                  disable_cudnn_benchmark=disable_cudnn_benchmark, num_workers=num_workers,
                  val_interval=val_interval, checkpoint_interval=checkpoint_interval,
                  checkpoint_history=checkpoint_history, init_weights=init_weights,
                  batch_size=batch_size, epochs=epochs, learning_rate=learning_rate,
                  end_learning_rate=end_learning_rate, momentum=momentum,
                  weights_decay=weights_decay, poly_power=poly_power, stage=stage, w1=w1, w2=w2,
                  freeze_batch_norm=freeze_batch_norm, experiment_id=experiment_id,
                  description=description, early_stopping=early_stopping,
                  best_validation_dict=best_validation_dict,
                  **dict.fromkeys(TRAIN_LOSS_KEYS + VAL_LOSS_KEYS))

    def save_full_checkpoint(epoch, filename):
        """The exact VARIABLES_IN_CHECKPOINT schema (train_or_resume.py:764-771
        there), the state copied to the host once; the master's only."""
        if not master:
            return
        t0 = datetime.now()
        state = dict(record, epoch=epoch, model_state_dict=_host_state(model),
                     optimizer_state_dict=optimizer_state_dict(optimizer, model, learning_rate,
                                                               momentum, weights_decay))
        save_checkpoint(checkpoints_dir, filename,
                        **{var: state[var] for var in settings.VARIABLES_IN_CHECKPOINT})
        path = os.path.join(checkpoints_dir, filename)
        summary['checkpoints'].append({'path': path, 'epoch': epoch, 'bytes': os.path.getsize(path),
                                       'seconds': (datetime.now() - t0).total_seconds()})

    with ConditionalContextManager(master, lambda: SummaryWriter(train_logs_dir), _NullWriter) \
            as train_logger, \
            ConditionalContextManager(master, lambda: SummaryWriter(val_logs_dir), _NullWriter) \
            as val_logger:
        _write_params_file(master,
            os.path.join(train_logs_dir, settings.PARAMS_FILE),
            "Timestamp: {:s}".format(process_start.strftime("%c")),
            "Device: {:s}".format(device_name),
            "Distributed: {:}".format(distributed) if distributed else None,
            "Mixed Precision: {:s}".format(mixed_precision) if mixed_precision else None,
            "No. of workers: {:d}".format(num_workers),
            "Dataset: {:s}".format(dataset.get('name', 'cityscapes')),
            "Dataset path: {:s}".format(dataset['path']),
            "Validation interval: {:d}".format(val_interval),
            "Checkpoint interval: {:d}".format(checkpoint_interval),
            "Checkpoint history: {:d}".format(checkpoint_history),
            "Initial weights: {:s}".format(init_weights) if init_weights else None,
            "Resuming checkpoint: {:s}".format(other_args['checkpoint'])
            if is_resuming_training and other_args.get('checkpoint') else None,
            "Batch size: {:d}".format(batch_size),
            "Epochs: {:d}".format(epochs),
            "Learning rate: {:f}".format(learning_rate),
            "End learning rate: {:f}".format(end_learning_rate),
            "Momentum: {:f}".format(momentum),
            "Weights decay: {:f}".format(weights_decay),
            "Poly power: {:f}".format(poly_power),
            "Stage: {:d}".format(stage),
            "Loss Weight 1: {:.4f}".format(w1) if stage > 1 else None,
            "Loss Weight 2: {:.4f}".format(w2) if stage > 2 else None,
            "Freeze batch normalization: {:}".format(freeze_batch_norm),
            "Experiment ID: {:}".format(experiment_id) if experiment_id else None,
            "Description: {:s}".format(description) if description else None,
            "Early stopping: {:}".format(early_stopping),
            "Devices: {:d} x {:s}".format(world, device_description(device)))

        n_params = sum(p.numel() for p in model.parameters())
        _print(INFO("Total training parameters: {:,}".format(n_params)))
        train_logger.add_text("INFO", "Total training parameters: {:,}".format(n_params),
                              starting_epoch + 1)
        train_logger.add_text("INFO", "Training started on {:s}.".format(process_start.strftime("%c")),
                              starting_epoch + 1)
        _print(INFO("Training on {:d} x {:s}, batch {:d} per rank, {:s}.".format(
            world, device_description(device), batch_size,
            str(compute_dtype).replace('torch.', ''))))
        if is_resuming_training:
            _print(INFO("Resuming after epoch {:d} from '{}'.".format(starting_epoch, warm_start)))
        _print(INFO("################################# Stage {:d} training STARTED #################################\n"
                   .format(stage), prefix='\n'))

        def note_primed():
            summary['primed_before_first_step'] = sum(p.stats['primed'] for p in primers)

        for epoch in range(starting_epoch + 1, epochs + 1):
            _print("\n=> EPOCH {0:d}/{1:d}".format(epoch, epochs))
            lr = scheduler.get_last_lr()[0]
            _print("Learning Rate: {:6f}".format(lr))
            epoch_start = datetime.now()
            train_losses, steps, input_waits = _train_epoch(
                train_step, train_loader, warp, device, epoch, lr, photometric_gen, stage,
                debug_nans, note_primed if epoch == starting_epoch + 1 else None)
            summary['steps'] += steps
            summary['train_losses'].append(dict(zip(LOSS_NAMES, train_losses)))
            record.update(zip(TRAIN_LOSS_KEYS, train_losses))
            _log_losses(train_logger, stage, epoch, train_losses)
            train_logger.add_scalar("Stage {:d}/Learning rate".format(stage), lr, epoch)

            if checkpoint_history > 0 and epoch % checkpoint_interval == 0:
                save_full_checkpoint(epoch, settings.CHECKPOINT_FILE.format(epoch=epoch))
                _print(INFO("Autosaved checkpoint for epoch {0:d} under '{1:s}'.".format(
                    epoch, settings.CHECKPOINTS_DIR.format(stage=stage))))
                old_epoch = epoch - checkpoint_history * checkpoint_interval
                old = os.path.join(checkpoints_dir, settings.CHECKPOINT_FILE.format(epoch=old_epoch))
                if master and old_epoch > 0 and os.path.isfile(old):
                    os.remove(old)

            if epoch % val_interval == 0:
                val_losses, val_miou, val_accuracy = _val_epoch(
                    model, eval_step, val_loader, eval_transform, device, epoch, ds,
                    best_validation_dict, stage, val_logger if master else None)
                summary['val'] = dict(zip(LOSS_NAMES, val_losses), epoch=epoch, mIoU=val_miou,
                                      accuracy=val_accuracy)
                record.update(zip(VAL_LOSS_KEYS, val_losses))
                _log_losses(val_logger, stage, epoch, val_losses)
                val_logger.add_scalar("Stage {:d}/Accuracy %".format(stage), val_accuracy, epoch)
                val_logger.add_scalar("Stage {:d}/mIoU %".format(stage), val_miou, epoch)

                # The validation and the train losses are all-reduced, so every
                # rank takes the same two decisions and leaves the loop together.
                if val_miou > best_validation_dict['best_miou_percent']:
                    best_validation_dict.update(epoch=epoch, best_miou_percent=val_miou,
                                                loss=val_losses[3])
                    for old in glob.glob(os.path.join(checkpoints_dir, "*_bestval.checkpoint")) \
                            if master else ():
                        os.remove(old)
                    save_full_checkpoint(epoch, settings.CHECKPOINT_FILE.format(
                        epoch='{:d}_bestval'.format(epoch)))

                if train_losses[3] < val_losses[3]:
                    if early_stopping:
                        log_string = "Early stopping was triggered at epoch {:d}.".format(epoch)
                        train_logger.add_text("INFO", log_string, epoch)
                        _print(INFO(log_string))
                        summary['early_stopped_at'] = epoch
                        break
                    _print(CAUTION("Average training loss < Average validation loss!"))

            scheduler.step()
            summary['epochs'].append({'epoch': epoch, 'input_waits': input_waits,
                                      'seconds': (datetime.now() - epoch_start).total_seconds()})
            if epoch < epochs:
                avg = np.mean([e['seconds'] for e in summary['epochs'][(-val_interval * 2):]])
                _print(INFO("Est. training completion in {:s}.".format(
                    makeSecondsPretty(avg * (epochs - epoch)))))

        if os.environ.get('DSRL_TPU_DEBUG_PARAM_DIGEST'):
            print("PARAM_DIGEST rank={:d} epoch={:d} {:s}".format(
                rank, locals().get('epoch', starting_epoch), _param_digest(model)), flush=True)
        weights_dir = os.path.join(experiment_id, settings.WEIGHTS_DIR.format(stage=stage))
        if master:
            save_weights(weights_dir, settings.FINAL_WEIGHTS_FILE, _host_state(model),
                         mixed_precision)
        summary['final_weights'] = os.path.join(weights_dir, settings.FINAL_WEIGHTS_FILE)
        summary['best_validation'] = dict(best_validation_dict)
        process_end = datetime.now()
        elapsed = (process_end - process_start).total_seconds()
        train_logger.add_text("INFO", "Training took {0:s} and completed on {1:s}.".format(
            makeSecondsPretty(elapsed), process_end.strftime("%c")), epochs)
        _print(INFO("Training took {:s}; weights written to '{:s}'.".format(
            makeSecondsPretty(elapsed), summary['final_weights'])))
        _print(INFO("################################# Stage {:d} training ENDED #################################"
                   .format(stage), prefix='\n'))
    for primer in primers:
        primer.join()
    # The master's writes above are the last thing the others wait for.
    parallel.barrier()
    parallel.destroy_process_group()
    summary['seconds'] = elapsed
    return summary


def _print(*args, **kwargs):
    """``print`` on the master rank only (the only process of a single-
    process run)."""
    if parallel.is_master_rank():
        print(*args, **kwargs)


def _rank_seed(seed, rank):
    """A rank's seed: ``seed`` itself on rank 0 (the single-process
    stream), else drawn from ``SeedSequence([rank, seed])``."""
    return seed if rank == 0 else int(np.random.SeedSequence([rank, seed]).generate_state(1)[0])


class _NullWriter:
    """The ``SummaryWriter`` of a rank that is not the master: writes nothing."""

    def add_scalar(self, *args):
        pass

    add_text = add_image = add_scalar


def _param_digest(model):
    """sha256 of the model's parameters, in order, as host float32 bytes."""
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _host_state(model):
    """The model's state dict as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _initialize(model, init_weights, stage, experiment_id):
    """Warm start (train_or_resume.py:134-155 there): ``--init-weights``, or
    at stage 1 the pretrained backbone, or at stages 2-3 the previous
    stage's ``final.weights``, all with ``strict=False``.  Returns the path
    of the weights file loaded, or None."""
    if init_weights:
        load_state_dict(model, load_checkpoint_or_weights(init_weights)['model_state_dict'],
                        strict=False)
        return init_weights
    if stage == 1:
        _print(INFO("Pretrained weights for ResNet101 will be used to initialize network before training."))
        load_pretrained_backbone(model, settings.WEIGHTS_ROOT_DIR)
        return None
    previous = os.path.join(experiment_id, settings.WEIGHTS_DIR.format(stage=stage - 1),
                            settings.FINAL_WEIGHTS_FILE)
    if os.path.isfile(previous):
        _print(INFO("'{:s}' weights file from previous stage was found and will be used "
                   "to initialize network before training.".format(previous)))
        load_state_dict(model, load_checkpoint_or_weights(previous)['model_state_dict'],
                        strict=False)
        return previous
    _print(CAUTION("'{:s}' weights file from previous stage was not found; initializing "
                  "with pretrained ResNet101 + Kaiming init.".format(previous)))
    load_pretrained_backbone(model, settings.WEIGHTS_ROOT_DIR)
    return None


def _log_losses(logger, stage, epoch, losses):
    """The per-epoch loss scalars under the JAX engine's tags
    (train_or_resume.py:349-354,404-409 there)."""
    ce, mse, fa, total = losses
    logger.add_scalar("Stage {:d}/CE Loss".format(stage), ce, epoch)
    if stage > 1:
        logger.add_scalar("Stage {:d}/MSE Loss".format(stage), mse, epoch)
        if stage > 2:
            logger.add_scalar("Stage {:d}/FA Loss".format(stage), fa, epoch)
        logger.add_scalar("Stage {:d}/Total Loss".format(stage), total, epoch)


def _loss_log(losses, stage):
    """The JAX engine's average-loss line (train_or_resume.py:599-605 there)
    for the (CE, MSE, FA, Total) averages."""
    ce, mse, fa, total = losses
    log = ["Avg. CE: {:.4f}".format(ce)]
    if stage > 1:
        log.append("Avg. MSE: {:.4f}".format(mse))
        if stage > 2:
            log.append("Avg. FA: {:.4f}".format(fa))
        log.append("Total Avg. Loss: {:.3f}".format(total))
    return log


def _update_meters(pending, meters):
    losses, n = pending
    for name in LOSS_NAMES:
        meters[name].update(float(losses[name]), n)


def _train_epoch(train_step, loader, warp, device, epoch, lr, generator, stage, debug_nans,
                 on_first_batch=None):
    """One epoch of steps -> (the loss averages, the steps, the seconds the
    loop waited on the loader before each step, the first wait including
    the workers' start-up: each the host time of a ``data.input_wait``
    span).  ``on_first_batch()`` runs when the first batch is in hand."""
    meters = {name: AverageMeter() for name in LOSS_NAMES}
    loader.batch_sampler.set_epoch(epoch)
    pending = None   # (device losses, batch size), read one step late
    steps = 0
    input_waits = []
    with span('data.input_wait') as wait:
        batches = iter(loader)
        batch = next(batches, None)
    while batch is not None:
        input_waits.append(wait.seconds)
        imgs_u8, segs_u8, batch_epoch, batch_index = batch
        if on_first_batch is not None and steps == 0:
            on_first_batch()
        imgs_w, segs_w = warp(batch_epoch, batch_index, imgs_u8.to(device, non_blocking=True),
                              segs_u8.to(device, non_blocking=True))
        try:
            losses = train_step(imgs_w, segs_w, lr, generator)
        except FloatingPointError as ex:   # --debug-nans
            raise FloatingPointError("--debug-nans: {} at epoch {:d}, step {:d}.".format(
                ex, epoch, steps + 1)) from None
        if pending is not None:
            _update_meters(pending, meters)
        pending = (losses, imgs_u8.shape[0])
        steps += 1
        with span('data.input_wait') as wait:
            batch = next(batches, None)
    if pending is not None:
        _update_meters(pending, meters)
    averages = tuple(meters[name]() for name in LOSS_NAMES)
    _print(', '.join(_loss_log(averages, stage)))
    return averages, steps, input_waits


def validate(model, eval_step, loader, transform, device, num_classes, on_batch=None):
    """One pass of the eval ``loader`` (data/transforms.py::make_eval_loader,
    the rank's shard under a process group) through ``eval_step`` ->
    ((CE, MSE, FA, Total), mIoU %, accuracy %).  Each batch's losses, three
    histograms and two counts stay on the device until the pass ends; then
    every batch's tally is summed over the ranks (one all-reduce), so every
    rank folds in the global batches as the JAX package's collective
    validation does (train_or_resume.py:656-695 there): the CE over the
    global valid pixels, the MSE and FA over the real samples, each batch
    weighted by its real samples.  ``on_batch(i, img_hi, pred)`` sees each
    of this rank's batches."""
    meters = {name: AverageMeter() for name in LOSS_NAMES}
    miou = mIoU(num_classes=num_classes)
    mean_accuracy = Accuracy()
    model.eval()
    rows = []
    for i, (imgs_u8, segs_u8, valid) in enumerate(loader):
        (img_lo, img_hi), (seg_hi, _) = transform(imgs_u8.to(device, non_blocking=True),
                                                  segs_u8.to(device, non_blocking=True))
        mask = valid.to(device, non_blocking=True)
        losses, pred, hists, acc = eval_step(model, img_lo, img_hi, seg_hi, mask)
        rows.append(eval_batch_tally(losses, hists, acc, mask.sum()))
        if on_batch is not None:
            on_batch(i, img_hi, pred)
    if rows:
        for row in parallel.all_reduce_sum(torch.stack(rows)).cpu().numpy():
            batch_losses, n, areas, counts = eval_batch_results(row, num_classes)
            for name, value in zip(LOSS_NAMES, batch_losses):
                meters[name].update(value, n)
            miou.update_from_areas(*areas)
            mean_accuracy.update_from_counts(*counts)
    return tuple(meters[name]() for name in LOSS_NAMES), miou(), mean_accuracy()


def _val_epoch(model, eval_step, loader, transform, device, epoch, ds, best, stage, logger):
    # The unseeded global RNG on purpose: the reference picks its example
    # with it too (train_or_resume.py:399 there), and the seeded streams
    # must not move.  Only the master (with a logger) logs one.
    example_index = np.random.randint(0, max(len(loader), 1)) if logger is not None else -1

    def log_example(i, img_hi, pred):
        if i == example_index:
            _log_example_image(logger, img_hi[0], pred[0], ds, epoch)

    losses, val_miou, val_accuracy = validate(model, eval_step, loader, transform, device,
                                              ds.NUM_CLASSES, log_example)
    best_miou = max(val_miou, best['best_miou_percent'])
    best_epoch = epoch if val_miou > best['best_miou_percent'] else best['epoch']
    _print("Validation results:\n{:s}".format(', '.join(_loss_log(losses, stage) + [
        "Accuracy %: {:.2f}".format(val_accuracy),
        "mIoU %: {:.2f}".format(val_miou),
        "Best mIoU % yet is {:.2f} at epoch {:d}.".format(best_miou, best_epoch)])))
    return losses, val_miou, val_accuracy


def _log_example_image(logger, img_hi, pred, ds, epoch):
    """One validation visualization per pass (train_or_resume.py:745-762
    there): the denormalized (OH, OW, 3) input | its class map | overlay."""
    img = img_hi.float().cpu().numpy() * np.asarray(ds.STD) + np.asarray(ds.MEAN)
    img = np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8).transpose(2, 0, 1)
    logger.add_image("EXAMPLE", make_input_output_visualization(img, pred.cpu().numpy(),
                                                                ds.CLASS_RGB_COLOR), epoch)


def _write_params_file(master, filename, *list_params):
    if not master:
        return
    with open(filename, mode='w') as params_file:
        params_file.write('\n'.join(x for x in list_params if x is not None))
