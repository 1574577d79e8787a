"""`test` command: single-image / directory / dataset-split inference.

Parity with reference command_handlers/test.py:17-118 and the JAX package's
``commands/test.py``: EXIF transpose, RGB convert, resize to
MODEL_OUTPUT_SIZE for display, then on the device normalize + align-corners
resize to MODEL_INPUT_SIZE, stage-1 forward and argmax; the uint8 class map
comes back and the palette visualization is saved as a PNG.  The dataset
mode walks a split from a starting index through the eval transform and
saves [target | prediction] pairs, the prediction masked where the target
is ignored; the reference's dataset mode crashes with a NameError
(test.py:96 uses an undefined ``input_image``), fixed here as in the JAX
package.  ``--compiled-model`` takes the forward from the program that
`compile-model` exported (commands/compile_model.py).  On a card the image
modes replay each frame's device work as one CUDA graph (``_build_pipeline``).
"""

import os
import os.path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image, ImageOps
from tqdm.auto import tqdm

from .. import consts, settings
from ..checkpoint import load_checkpoint_or_weights
from ..data import make_eval_transform_fn
from ..metrics.device import argmax_lastdim
from ..models import DSRL, load_state_dict
from ..ops.colorize import make_input_output_visualization
from ..utils import (INFO, timethis, getFilesWithExtension, swapTupleValues,
                     select_device, span)


def load_model(weights, num_classes, device):
    """The stage-1 model in eval mode on ``device``, loaded from a
    ``.weights``/``.checkpoint`` file with ``strict=False`` (a stage-2/3
    file's SISR and FA keys are ignored)."""
    model = DSRL(num_classes=num_classes)
    state = load_checkpoint_or_weights(weights)
    load_state_dict(model, state['model_state_dict'], strict=False)
    return model.to(device).eval()


def _build_forward(weights, ds_settings, device, compiled_model):
    """fn((1, 3, *MODEL_INPUT_SIZE) float32 normalized) -> SSSR logits
    (1, C, *MODEL_OUTPUT_SIZE), from the weights or, with
    ``compiled_model``, from the exported program."""
    if compiled_model:
        from .compile_model import load_compiled_model
        forward = load_compiled_model(weights, device)
    else:
        forward = load_model(weights, ds_settings.NUM_CLASSES, device)
    return lambda x: forward(x)[0]


def _mean_std(ds_settings, device):
    return (torch.tensor(ds_settings.MEAN, dtype=torch.float32, device=device),
            torch.tensor(ds_settings.STD, dtype=torch.float32, device=device))


def _normalise_resize(x_u8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) image on the device -> the (1, 3, *MODEL_INPUT_SIZE) float32
    network input: /255, normalize, align-corners resize."""
    x = (x_u8.float() / 255.0 - mean) / std
    return F.interpolate(x.permute(2, 0, 1)[None], size=settings.MODEL_INPUT_SIZE,
                         mode='bilinear', align_corners=True)


def _class_map(logits: torch.Tensor) -> torch.Tensor:
    """SSSR logits (1, C, H, W) -> the uint8 (H, W) class map, on their device."""
    return argmax_lastdim(logits[0].permute(1, 2, 0)).to(torch.uint8)


def network_input(img_u8: np.ndarray, ds_settings, device) -> torch.Tensor:
    """uint8 (H, W, 3) image -> the (1, 3, *MODEL_INPUT_SIZE) float32
    network input on ``device``: /255, normalize, align-corners resize."""
    mean, std = _mean_std(ds_settings, device)
    return _normalise_resize(torch.tensor(img_u8, device=device), mean, std)


def _eager_pipeline(forward, ds_settings, device):
    """The per-frame pipeline as eager calls, each frame's input and
    constants made anew."""
    def pipeline(img_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            with span('test.input'):
                x = network_input(img_u8, ds_settings, device)
            with span('test.forward', device=True):
                logits = forward(x)
            with span('test.readback'):
                return _class_map(logits).cpu().numpy()

    return pipeline


class _CapturedFrame:
    """One frame shape and dtype of :class:`_GraphPipeline`: a pinned host
    staging buffer and the device input it is copied to, the CUDA graph of
    ``program`` (device input -> device class map) in its own memory pool,
    and a pinned host buffer for the class map.

    ``program`` runs once eagerly on a side stream first: cuDNN's autotune
    over the shapes, the resize's matrices (``ops/resize.py``) and the
    libraries' handles are made there, as none may be made in a capture."""

    def __init__(self, program, img: np.ndarray, device):
        self.staging = torch.from_numpy(np.array(img)).pin_memory()
        self.input = self.staging.to(device)
        side, current = torch.cuda.Stream(device), torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            program(self.input)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.class_map = program(self.input)
        self.host_map = torch.empty(self.class_map.shape, dtype=self.class_map.dtype,
                                    pin_memory=True)


class _GraphPipeline:
    """The per-frame pipeline on a card: the whole device program
    (normalize, resize, forward, argmax, uint8) replayed as one CUDA graph,
    captured on the first frame of each shape and dtype; the frame and the
    class map cross through pinned buffers.  The graph launches the kernels
    the eager pipeline launches, on the algorithms cuDNN's autotune picked,
    so its class maps are the eager ones bit for bit.  Each call returns a
    class map of its own."""

    def __init__(self, forward, ds_settings, device):
        self.device = device
        self.frames = {}
        mean, std = _mean_std(ds_settings, device)
        self.program = lambda x_u8: _class_map(forward(_normalise_resize(x_u8, mean, std)))

    def __call__(self, img_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            key = (img_u8.shape, img_u8.dtype)
            frame = self.frames.get(key)
            if frame is None:
                with span('test.capture'):
                    frame = self.frames[key] = _CapturedFrame(self.program, img_u8, self.device)
            with span('test.input'):
                np.copyto(frame.staging.numpy(), img_u8)
                frame.input.copy_(frame.staging, non_blocking=True)
            with span('test.forward', device=True):
                with span('test.replay'):
                    frame.graph.replay()
            with span('test.readback'):
                frame.host_map.copy_(frame.class_map, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                return frame.host_map.numpy().copy()


def _build_pipeline(forward, ds_settings, device):
    """fn(uint8 (H, W, 3) image at MODEL_OUTPUT_SIZE) -> uint8 (H, W) class
    map: uint8 crosses to the device and back, all per-pixel math runs
    there.  Its three parts are the spans ``test.input``, ``test.forward``
    and ``test.readback``.  On a card the device work is one CUDA graph
    replay a frame (:class:`_GraphPipeline`; spans ``test.capture`` and
    ``test.replay``); elsewhere it runs eagerly."""
    if device.type == 'cuda':
        return _GraphPipeline(forward, ds_settings, device)
    return _eager_pipeline(forward, ds_settings, device)


def _test_images(forward, ds_settings, device, image_file, images_dir, output_dir, show):
    """The image modes; returns (written PNGs, inference seconds each)."""
    pipeline = _build_pipeline(forward, ds_settings, device)
    image_filenames = [image_file] if image_file else \
        getFilesWithExtension(images_dir, consts.IMAGE_FILE_EXTENSIONS, with_path=True)
    outputs, seconds = [], []
    for image_filename in image_filenames:
        with Image.open(image_filename) as src, \
                ImageOps.exif_transpose(src) \
                .convert('RGB') \
                .resize(swapTupleValues(settings.MODEL_OUTPUT_SIZE), resample=Image.BILINEAR) as input_image:
            arr = np.asarray(input_image, dtype=np.uint8)
            with timethis(INFO("Inference required {:}.")) as timer:
                pred = pipeline(arr)
        seconds.append(timer.elapsed)

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
        outputs.append(out_name)
    return outputs, seconds


def _test_dataset(forward, dataset, device, output_dir, show, no_interactive):
    """The dataset mode (JAX commands/test.py:118-156); returns (written
    PNGs, inference seconds each)."""
    ds_settings = dataset['settings']
    transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                       ds_settings.MEAN, ds_settings.STD,
                                       ds_settings.LABEL_MAPPING_LUT)
    mean = torch.tensor(ds_settings.MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(ds_settings.STD, dtype=torch.float32, device=device)
    test_dataset = dataset['class'](dataset['path'], split=dataset.get('split', 'val'))

    print(INFO("Press ENTER to show next pair of input and output. Use CTRL+c to quit."))
    outputs, seconds = [], []
    for i in tqdm(range(len(test_dataset)), desc='TESTING', colour='yellow',
                  position=0, leave=False):
        if i < dataset.get('starting_index', 0):
            continue
        img_u8, seg_u8 = test_dataset[i]
        with torch.inference_mode():
            (img_lo, img_hi), (seg_hi, _) = transform(torch.tensor(img_u8[None], device=device),
                                                      torch.tensor(seg_u8[None], device=device))
            with timethis(INFO("Inference required {:}.")) as timer:
                logits = forward(img_lo.permute(0, 3, 1, 2))
                pred = argmax_lastdim(logits[0].permute(1, 2, 0)).to(torch.uint8).cpu().numpy()
            # The display image in the JAX package's float32 op order, so
            # that its bits are that package's.
            disp = ((img_hi[0] * std + mean) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
            disp = disp.permute(2, 0, 1).cpu().numpy()
            target = seg_hi[0].cpu().numpy()
        seconds.append(timer.elapsed)

        pred[target == ds_settings.IGNORE_CLASS_LABEL] = ds_settings.IGNORE_CLASS_LABEL
        vis_target = make_input_output_visualization(disp, target, ds_settings.CLASS_RGB_COLOR)
        vis_pred = make_input_output_visualization(disp, pred, ds_settings.CLASS_RGB_COLOR)
        vis = np.concatenate((vis_target, vis_pred), axis=1).transpose((1, 2, 0))

        with Image.fromarray(vis, mode='RGB') as vis_img:
            os.makedirs(output_dir, exist_ok=True)
            out_name = os.path.join(output_dir, str(i) + '.png')
            vis_img.save(out_name, format='PNG')
            if show:
                vis_img.show(title='Segmentation output')
        print(INFO("Output image saved as: {0:s}.".format(out_name)))
        outputs.append(out_name)
        if not no_interactive and os.isatty(0):
            input()
    return outputs, seconds


def test(image_file, images_dir, output_dir, weights, device, dataset=None,
         compiled_model=False, show=False, no_interactive=False,
         disable_cudnn_benchmark=False, **other_args):
    """--show opens the visualization in single-image-file and dataset
    modes; --images-dir never displays (the reference shows "only if a
    single image file is specified", test.py:68-70).  Dataset mode pauses
    for ENTER between images unless --no-interactive or stdin is not a
    terminal (reference test.py:63-72,102).  Returns ``{'outputs': [PNG
    paths], 'seconds': [inference seconds per image]}``."""
    device = select_device(device, cudnn_benchmark=not disable_cudnn_benchmark)
    # Same FIXME as the reference (test.py:22-24): normalization settings are
    # not stored in weights; default to cityscapes.
    ds_settings = (dataset or settings.DATASETS['cityscapes'])['settings']
    forward = _build_forward(weights, ds_settings, device, compiled_model)
    if image_file or images_dir:
        outputs, seconds = _test_images(forward, ds_settings, device, image_file, images_dir,
                                        output_dir, show)
    else:
        outputs, seconds = _test_dataset(forward, dataset, device, output_dir, show,
                                         no_interactive)
    return {'outputs': outputs, 'seconds': seconds}
