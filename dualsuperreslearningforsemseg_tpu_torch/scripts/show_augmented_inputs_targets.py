"""Augmentation viewer (parity: reference scripts/
show_augmented_inputs_targets.py:17-67): renders augmented (input, target)
pairs through the port's train-time augmentation, the device warp
(``data/augment.py::make_warp_transform``) and then the photometric tail
(``make_device_post_fn``), whose kernel K2 runs on the card.  The draws come
from the port's RNGs (the JAX package's warp matrices for (seed, 0, n), a
``torch.Generator`` for the photometric decisions), not the JAX script's."""

import argparse
import os

import numpy as np
import torch
from PIL import Image

from .. import settings
from ..data import AugmentConfig, make_device_post_fn, make_warp_transform
from ..ops.colorize import make_input_output_visualization
from ..utils import INFO, ValidateDatasetNameAndSplit, select_device


def show_augmented_inputs_targets(args):
    """Returns the written PNGs' paths."""
    parser = argparse.ArgumentParser(
        description="Show augmented inputs fed to model and target outputs during training.")
    parser.add_argument('--dataset', required=True, nargs=2, metavar=('DATASET', 'SPLIT'),
                        action=ValidateDatasetNameAndSplit, const=settings.DATASETS,
                        help="Dataset and split to operate on")
    parser.add_argument('--shuffle', action='store_true')
    parser.add_argument('--output-dir', type=str, default=settings.OUTPUTS_DIR,
                        help="Where to save visualizations (also shown if a display exists)")
    parser.add_argument('--limit', type=int, default=0, help="Stop after N samples (0 = all)")
    parser.add_argument('--device', default=settings.DEFAULT_DEVICE, type=str.casefold,
                        choices=settings.SUPPORTED_DEVICES,
                        help="Device the augmentation runs on (cuda or cpu)")
    args = parser.parse_args(args)
    device = select_device(args.device)

    entry = settings.DATASETS[args.dataset[0]]
    ds_settings = entry['settings']
    dataset = entry['class'](entry['path'], split=args.dataset[1])

    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE,
                        output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds_settings.MEAN, std=ds_settings.STD)
    warp = make_warp_transform(cfg, ds_settings.LABEL_MAPPING_LUT, settings.RANDOM_SEED)
    post = make_device_post_fn(cfg)
    generator = torch.Generator(device).manual_seed(settings.RANDOM_SEED)
    mean = torch.tensor(ds_settings.MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(ds_settings.STD, dtype=torch.float32, device=device)

    order = np.random.permutation(len(dataset)) if args.shuffle else np.arange(len(dataset))
    print(INFO("Press ENTER to show next pair of input and output. Use CTRL+c to quit."))
    saved = []
    try:
        for n, i in enumerate(order):
            if args.limit and n >= args.limit:
                break
            img_u8, seg_u8 = dataset[int(i)]
            imgs, segs = warp(0, n, torch.tensor(img_u8[None], device=device),
                              torch.tensor(seg_u8[None], device=device))
            (_, img_hi), (seg_hi, _) = post(imgs, segs, generator)
            img = ((img_hi[0] * std + mean) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
            img = img.permute(2, 0, 1).cpu().numpy()
            target = seg_hi[0].cpu().numpy()
            vis = make_input_output_visualization(img, target, ds_settings.CLASS_RGB_COLOR)
            os.makedirs(args.output_dir, exist_ok=True)
            out = os.path.join(args.output_dir, 'augmented_{:d}.png'.format(int(i)))
            with Image.fromarray(vis.transpose(1, 2, 0), mode='RGB') as im:
                im.save(out)
                if os.isatty(0):
                    im.show(title=str(i))
            print(INFO("Saved {:s}".format(out)))
            saved.append(out)
            if os.isatty(0):
                input()
    except KeyboardInterrupt:
        pass
    return saved
