"""`test` command: single-image / directory inference.

Parity with reference command_handlers/test.py:17-118 and the JAX package's
``commands/test.py`` image modes: EXIF transpose, RGB convert, resize to
MODEL_OUTPUT_SIZE for display, then on the device normalize + align-corners
resize to MODEL_INPUT_SIZE, stage-1 forward and argmax; the uint8 class map
comes back and the palette visualization is saved as a PNG.  The dataset
mode and ``--compiled-model`` are not ported yet.
"""

import os
import os.path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image, ImageOps

from .. import consts, settings
from ..checkpoint import load_checkpoint_or_weights
from ..metrics.device import argmax_lastdim
from ..models import DSRL, load_state_dict
from ..ops.colorize import make_input_output_visualization
from ..utils import (INFO, timethis, getFilesWithExtension, swapTupleValues,
                     select_device)


def load_model(weights, num_classes, device):
    """The stage-1 model in eval mode on ``device``, loaded from a
    ``.weights``/``.checkpoint`` file with ``strict=False`` (a stage-2/3
    file's SISR and FA keys are ignored)."""
    model = DSRL(num_classes=num_classes)
    state = load_checkpoint_or_weights(weights)
    load_state_dict(model, state['model_state_dict'], strict=False)
    return model.to(device).eval()


def _build_pipeline(weights, ds_settings, device):
    """fn(uint8 (H, W, 3) image at MODEL_OUTPUT_SIZE) -> uint8 (H, W) class
    map: uint8 crosses to the device and back, all per-pixel math runs
    there."""
    model = load_model(weights, ds_settings.NUM_CLASSES, device)
    mean = torch.tensor(ds_settings.MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(ds_settings.STD, dtype=torch.float32, device=device)

    def pipeline(img_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = (torch.tensor(img_u8, device=device).float() / 255.0 - mean) / std
            x = F.interpolate(x.permute(2, 0, 1)[None], size=settings.MODEL_INPUT_SIZE,
                              mode='bilinear', align_corners=True)
            logits = model(x)[0]
            return argmax_lastdim(logits[0].permute(1, 2, 0)).to(torch.uint8).cpu().numpy()

    return pipeline


def test(image_file, images_dir, output_dir, weights, device, show=False,
         disable_cudnn_benchmark=False, **other_args):
    """--show opens the visualization in single-image-file mode only (the
    reference shows "only if a single image file is specified",
    test.py:68-70)."""
    device = select_device(device, cudnn_benchmark=not disable_cudnn_benchmark)
    # Same FIXME as the reference (test.py:22-24): normalization settings are
    # not stored in weights; default to cityscapes.
    ds_settings = settings.DATASETS['cityscapes']['settings']
    pipeline = _build_pipeline(weights, ds_settings, device)
    image_filenames = [image_file] if image_file else \
        getFilesWithExtension(images_dir, consts.IMAGE_FILE_EXTENSIONS, with_path=True)

    for image_filename in image_filenames:
        with Image.open(image_filename) as src, \
                ImageOps.exif_transpose(src) \
                .convert('RGB') \
                .resize(swapTupleValues(settings.MODEL_OUTPUT_SIZE), resample=Image.BILINEAR) as input_image:
            arr = np.asarray(input_image, dtype=np.uint8)
            with timethis(INFO("Inference required {:}.")):
                pred = pipeline(arr)

        vis_image = make_input_output_visualization(arr.transpose((2, 0, 1)), pred,
                                                    ds_settings.CLASS_RGB_COLOR)
        with Image.fromarray(vis_image.transpose((1, 2, 0)), mode='RGB') as vis:
            os.makedirs(output_dir, exist_ok=True)
            out_name = os.path.join(output_dir,
                                    os.path.splitext(os.path.basename(image_filename))[0] + '.png')
            vis.save(out_name, format='PNG')
            if image_file and show:
                vis.show(title='Segmentation output')
        print(INFO("Output image saved as: {0:s}.".format(out_name)))
