"""`benchmark` command: full-split eval producing CE / mIoU / Accuracy.

Parity with reference command_handlers/benchmark.py:16-95 and the JAX
package's ``commands/benchmark.py``: stage-1 model, val/test transforms,
metric accumulation, printed results and ``outputs/benchmark.txt``.  One
process, one device.  The loader reads through the raw pair cache when
``DSRL_TPU_RAW_CACHE`` is set, primed in the background unless
``DSRL_TPU_PRIME_RAW_CACHE=0`` (data/pipeline.py).  Each batch runs the eval step (train/steps.py), whose
tail is the fused eval-tail kernel on the card; the per-batch CE, histograms
and counts stay on the device until the loop ends.

The reference averages CE with the *nominal* batch size even for the ragged
final batch (benchmark.py:65) — documented bug, not replicated: we weight by
the actual batch size.
"""

import os
import os.path
from datetime import datetime

from .. import settings
from ..data import make_eval_transform_fn, make_eval_loader, prime_raw_cache
from ..metrics import mIoU, Accuracy, AverageMeter
from ..train import make_eval_step
from ..utils import INFO, FATAL, select_device, device_description
from .test import load_model


def benchmark(weights, dataset, device, num_workers, batch_size,
              disable_cudnn_benchmark=False, **other_args):
    process_start_timestamp = datetime.now()
    device = select_device(device, cudnn_benchmark=not disable_cudnn_benchmark)
    ds_settings = dataset['settings']

    test_dataset = dataset['class'](dataset['path'], split=dataset.get('split', 'val'))
    if len(test_dataset) == 0:
        raise Exception(FATAL("Cityscapes dataset was not found under '{:s}'. "
                              "Please refer to 'README.md'.".format(dataset['path'])))
    loader = make_eval_loader(test_dataset, batch_size, num_workers, device)
    # The raw pair cache is filled while the model loads (JAX
    # commands/benchmark.py:56-64).
    primer = prime_raw_cache(loader) \
        if os.environ.get('DSRL_TPU_PRIME_RAW_CACHE', '1') != '0' else None
    model = load_model(weights, ds_settings.NUM_CLASSES, device)

    transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                       ds_settings.MEAN, ds_settings.STD,
                                       ds_settings.LABEL_MAPPING_LUT)
    eval_step = make_eval_step(ds_settings.NUM_CLASSES, ds_settings.IGNORE_CLASS_LABEL)

    pending = []
    for imgs_u8, segs_u8, valid in loader:
        n = imgs_u8.shape[0]
        (img_lo, img_hi), (seg_hi, _) = transform(imgs_u8.to(device, non_blocking=True),
                                                  segs_u8.to(device, non_blocking=True))
        losses, _, hists, acc = eval_step(model, img_lo, img_hi, seg_hi, valid.to(device))
        pending.append((losses['CE'], hists, acc, n))
    if primer is not None:
        primer.join()

    CE_avg_loss = AverageMeter()
    miou = mIoU(num_classes=ds_settings.NUM_CLASSES)
    accuracy_mean = Accuracy()
    n_images = 0
    for ce, hists, acc, n in pending:
        n_images += n
        CE_avg_loss.update(float(ce), n)
        miou.update_from_areas(*[h.cpu().numpy() for h in hists])
        accuracy_mean.update_from_counts(*[int(v) for v in acc])

    elapsed = (datetime.now() - process_start_timestamp).total_seconds()
    print("-------- RESULTS --------")
    print("Avg. Cross Entropy Error: {:.3f}".format(CE_avg_loss()))
    print("mIoU %: {:.2f}".format(miou()))
    print("Mean Accuracy %: {:.2f}".format(accuracy_mean()))
    print("Throughput: {:.2f} images/sec (end-to-end, incl. decode and model load; 1 device: {:s})"
          .format(n_images / max(elapsed, 1e-9), device_description(device)))

    os.makedirs(settings.OUTPUTS_DIR, exist_ok=True)
    output_benchmark_filename = os.path.join(settings.OUTPUTS_DIR, 'benchmark.txt')
    with open(output_benchmark_filename, 'w') as benchmark_file:
        benchmark_file.write("Benchmarking results on Cityscapes dataset's {:s} split\n\n".format(
            dataset.get('split', 'val')))
        benchmark_file.write("On: {:s}\n".format(process_start_timestamp.strftime("%c")))
        benchmark_file.write("Weights file: {:s}\n\n".format(weights))
        benchmark_file.write("Avg. Cross Entropy Error: {:.3f}\n".format(CE_avg_loss()))
        benchmark_file.write("mIoU %: {:.2f}\n".format(miou()))
        benchmark_file.write("Mean Accuracy %: {:.2f}\n".format(accuracy_mean()))
    print(INFO("Benchmark results written to '{:s}'.".format(output_benchmark_filename)))
    return {'CE': CE_avg_loss(), 'mIoU': miou(), 'accuracy': accuracy_mean(),
            'images': n_images, 'seconds': elapsed}
