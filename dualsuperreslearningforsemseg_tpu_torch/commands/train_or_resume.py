"""`train` command, stages 1 to 3: the JAX package's training engine
(commands/train_or_resume.py:90-607 there) as far as the three stages need it.

* Model: ``DSRL(stage=stage)`` with the seeded Kaiming init from
  ``RANDOM_SEED``, then ``--init-weights`` (``strict=False``); without it,
  stage 1 loads the pretrained ResNet-101 backbone when
  ``weights/resnet101_pretrained.pth`` exists (never downloaded), and
  stages 2 and 3 warm-start from the previous stage's
  ``<experiment>/weights/stage{k-1}/final.weights`` (``strict=False``), or,
  where that file is missing, fall back to the pretrained backbone with a
  CAUTION (train_or_resume.py:134-155 there).
* Seeds: ``nn.Dropout`` draws from torch's default generators, seeded with
  ``RANDOM_SEED + 1000 * (starting_epoch + 1)`` (train_or_resume.py:270
  there); the photometric draws from a generator on the device seeded with
  that value plus one.
* Each step: the loader's uint8 batch goes to the device, is warped there
  with the JAX package's matrices for (epoch, batch) (data/augment.py), and
  the train step (train/steps.py) runs K2 (at stages 2-3 emitting the
  unshuffled SISR target too), the forward, K1 forward and backward, the
  MSE and, at stage 3, K4 forward and backward, and SGD.  Losses are read
  one step late, so the host does not wait for the step it just queued.
* ``PolynomialLR`` steps once per epoch; validation every ``--val-interval``
  epochs runs the eval step (K3, and K4 at stage 3), the eval loader and the
  host metrics.  The averages print as the JAX engine prints them.
* ``final.weights`` is written under ``<experiment>/weights/stage{k}/``.

Not ported yet (ROADMAP.md queue 3): autosaved and best-validation
``.checkpoint`` files, TensorBoard logs and ``params.txt``, ``resume-train``,
early stopping, ``--distributed``, ``--profile``, ``--dry-run``,
``--debug-nans``.
"""

import os.path
from datetime import datetime

import numpy as np
import torch

from .. import settings
from ..checkpoint import load_checkpoint_or_weights, save_weights
from ..data import (AugmentConfig, make_warp_transform, make_device_post_fn, make_train_loader,
                    make_eval_transform_fn, make_eval_loader)
from ..metrics import mIoU, Accuracy, AverageMeter
from ..models import DSRL, PolynomialLR, init_weights as init_model, load_pretrained_backbone, \
    load_state_dict
from ..models.dsrl import SISR_UPSCALE
from ..train import make_train_step, make_eval_step, make_sgd
from ..utils import INFO, CAUTION, FATAL, select_device, device_description, makeSecondsPretty

LOSS_NAMES = ('CE', 'MSE', 'FA', 'Total')


def train(device, mixed_precision, disable_cudnn_benchmark, num_workers, dataset, val_interval,
          init_weights, batch_size, epochs, learning_rate, end_learning_rate, momentum,
          weights_decay, poly_power, stage, w1, w2, freeze_batch_norm, experiment_id,
          **other_args):
    """Trains ``stage`` and writes its ``final.weights``; returns a summary
    dict (steps, per-epoch train losses, the last validation, the weights
    path, the file the model warm-started from)."""
    process_start = datetime.now()
    device = select_device(device, cudnn_benchmark=not disable_cudnn_benchmark)
    ds = dataset['settings']
    compute_dtype = settings.mixed_precision_to_dtype(mixed_precision)
    amp_dtype = None if compute_dtype == torch.float32 else compute_dtype
    print(CAUTION("This port's 'train' writes final.weights only: autosaved and best-validation "
                  ".checkpoint files, TensorBoard logs and resume-train are not ported yet "
                  "(ROADMAP.md queue 3)."))

    starting_epoch = 0
    seed = settings.RANDOM_SEED + 1000 * (starting_epoch + 1)
    torch.manual_seed(seed)     # the CPU and every CUDA default generator: dropout masks
    photometric_gen = torch.Generator(device=device).manual_seed(seed + 1)

    model = init_model(DSRL(num_classes=ds.NUM_CLASSES, stage=stage),
                       torch.Generator().manual_seed(settings.RANDOM_SEED))
    warm_start = _initialize(model, init_weights, stage, experiment_id)
    model.to(device)
    optimizer = make_sgd(model, learning_rate, momentum, weights_decay)
    scheduler = PolynomialLR(learning_rate, max_decay_steps=epochs, end_learning_rate=end_learning_rate,
                             power=poly_power, last_epoch=starting_epoch - 1)

    train_set = dataset['class'](dataset['path'], split='train')
    if len(train_set) == 0:
        raise Exception(FATAL("Cityscapes dataset was not found under '{:s}'.".format(dataset['path'])))
    if len(train_set) < batch_size:
        raise Exception(FATAL("The train split has {} images, fewer than one batch of {}.".format(
            len(train_set), batch_size)))
    val_set = dataset['class'](dataset['path'], split='val')

    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD, ignore_label=ds.IGNORE_CLASS_LABEL)
    warp = make_warp_transform(cfg, ds.LABEL_MAPPING_LUT, settings.RANDOM_SEED)
    post_fn = make_device_post_fn(cfg, dtype=compute_dtype,
                                  unshuffle_hi=SISR_UPSCALE if stage > 1 else 0)
    train_step = make_train_step(model, optimizer, stage, w1, w2, ds.IGNORE_CLASS_LABEL,
                                 freeze_batch_norm, post_fn=post_fn, amp_dtype=amp_dtype)
    eval_step = make_eval_step(ds.NUM_CLASSES, ds.IGNORE_CLASS_LABEL, stage, w1, w2)
    eval_transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                            ds.MEAN, ds.STD, ds.LABEL_MAPPING_LUT)
    train_loader = make_train_loader(train_set, batch_size, num_workers, device,
                                     seed=settings.RANDOM_SEED)
    val_loader = make_eval_loader(val_set, batch_size, num_workers, device)

    n_params = sum(p.numel() for p in model.parameters())
    print(INFO("Total training parameters: {:,}".format(n_params)))
    print(INFO("Training on {:s}, batch {:d}, {:s}.".format(
        device_description(device), batch_size, str(compute_dtype).replace('torch.', ''))))
    print(INFO("################################# Stage {:d} training STARTED #################################\n"
               .format(stage), prefix='\n'))

    best = {'epoch': -1, 'best_miou_percent': 0.0}
    summary = {'steps': 0, 'train_losses': [], 'val': None, 'warm_start': warm_start}
    epoch_seconds = []
    for epoch in range(starting_epoch + 1, epochs + 1):
        print("\n=> EPOCH {0:d}/{1:d}".format(epoch, epochs))
        lr = scheduler.get_last_lr()[0]
        print("Learning Rate: {:6f}".format(lr))
        epoch_start = datetime.now()
        train_losses, steps = _train_epoch(train_step, train_loader, warp, device, epoch, lr,
                                           photometric_gen, stage)
        summary['steps'] += steps
        summary['train_losses'].append(dict(zip(LOSS_NAMES, train_losses)))

        if epoch % val_interval == 0:
            val_losses, val_miou, val_accuracy = _val_epoch(model, eval_step, val_loader,
                                                            eval_transform, device, epoch, ds, best,
                                                            stage)
            summary['val'] = dict(zip(LOSS_NAMES, val_losses), epoch=epoch, mIoU=val_miou,
                                  accuracy=val_accuracy)
            if val_miou > best['best_miou_percent']:
                best.update(epoch=epoch, best_miou_percent=val_miou)
            if train_losses[3] < val_losses[3]:
                print(CAUTION("Average training loss < Average validation loss!"))

        scheduler.step()
        if epoch < epochs:
            epoch_seconds.append((datetime.now() - epoch_start).total_seconds())
            avg = np.mean(epoch_seconds[(-val_interval * 2):])
            print(INFO("Est. training completion in {:s}.".format(
                makeSecondsPretty(avg * (epochs - epoch)))))

    weights_dir = os.path.join(experiment_id, settings.WEIGHTS_DIR.format(stage=stage))
    save_weights(weights_dir, settings.FINAL_WEIGHTS_FILE,
                 {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
                 mixed_precision)
    summary['final_weights'] = os.path.join(weights_dir, settings.FINAL_WEIGHTS_FILE)
    elapsed = (datetime.now() - process_start).total_seconds()
    print(INFO("Training took {:s}; weights written to '{:s}'.".format(
        makeSecondsPretty(elapsed), summary['final_weights'])))
    print(INFO("################################# Stage {:d} training ENDED #################################"
               .format(stage), prefix='\n'))
    summary['seconds'] = elapsed
    return summary


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
        print(INFO("Pretrained weights for ResNet101 will be used to initialize network before training."))
        load_pretrained_backbone(model, settings.WEIGHTS_ROOT_DIR)
        return None
    previous = os.path.join(experiment_id, settings.WEIGHTS_DIR.format(stage=stage - 1),
                            settings.FINAL_WEIGHTS_FILE)
    if os.path.isfile(previous):
        print(INFO("'{:s}' weights file from previous stage was found and will be used "
                   "to initialize network before training.".format(previous)))
        load_state_dict(model, load_checkpoint_or_weights(previous)['model_state_dict'],
                        strict=False)
        return previous
    print(CAUTION("'{:s}' weights file from previous stage was not found; initializing "
                  "with pretrained ResNet101 + Kaiming init.".format(previous)))
    load_pretrained_backbone(model, settings.WEIGHTS_ROOT_DIR)
    return None


def _loss_log(meters, stage):
    """The JAX engine's average-loss line (train_or_resume.py:599-605 there)."""
    log = ["Avg. CE: {:.4f}".format(meters['CE']())]
    if stage > 1:
        log.append("Avg. MSE: {:.4f}".format(meters['MSE']()))
        if stage > 2:
            log.append("Avg. FA: {:.4f}".format(meters['FA']()))
        log.append("Total Avg. Loss: {:.3f}".format(meters['Total']()))
    return log


def _update_meters(pending, meters):
    losses, n = pending
    for name in LOSS_NAMES:
        meters[name].update(float(losses[name]), n)


def _train_epoch(train_step, loader, warp, device, epoch, lr, generator, stage):
    meters = {name: AverageMeter() for name in LOSS_NAMES}
    loader.batch_sampler.set_epoch(epoch)
    pending = None   # (device losses, batch size), read one step late
    steps = 0
    for imgs_u8, segs_u8, batch_epoch, batch_index in loader:
        imgs_w, segs_w = warp(batch_epoch, batch_index, imgs_u8.to(device, non_blocking=True),
                              segs_u8.to(device, non_blocking=True))
        losses = train_step(imgs_w, segs_w, lr, generator)
        if pending is not None:
            _update_meters(pending, meters)
        pending = (losses, imgs_u8.shape[0])
        steps += 1
    if pending is not None:
        _update_meters(pending, meters)
    print(', '.join(_loss_log(meters, stage)))
    return tuple(meters[name]() for name in LOSS_NAMES), steps


def _val_epoch(model, eval_step, loader, transform, device, epoch, ds, best, stage):
    meters = {name: AverageMeter() for name in LOSS_NAMES}
    miou = mIoU(num_classes=ds.NUM_CLASSES)
    mean_accuracy = Accuracy()
    model.eval()
    pending = []   # per-batch results stay on the device until the pass ends
    for imgs_u8, segs_u8 in loader:
        n = imgs_u8.shape[0]
        (img_lo, img_hi), (seg_hi, _) = transform(imgs_u8.to(device, non_blocking=True),
                                                  segs_u8.to(device, non_blocking=True))
        losses, _, hists, acc = eval_step(model, img_lo, img_hi, seg_hi, torch.ones(n, device=device))
        pending.append((losses, hists, acc, n))
    for losses, hists, acc, n in pending:
        _update_meters((losses, n), meters)
        miou.update_from_areas(*[h.cpu().numpy() for h in hists])
        mean_accuracy.update_from_counts(*[int(v) for v in acc])

    best_miou = max(miou(), best['best_miou_percent'])
    best_epoch = epoch if miou() > best['best_miou_percent'] else best['epoch']
    print("Validation results:\n{:s}".format(', '.join(_loss_log(meters, stage) + [
        "Accuracy %: {:.2f}".format(mean_accuracy()),
        "mIoU %: {:.2f}".format(miou()),
        "Best mIoU % yet is {:.2f} at epoch {:d}.".format(best_miou, best_epoch)])))
    return tuple(meters[name]() for name in LOSS_NAMES), miou(), mean_accuracy()
