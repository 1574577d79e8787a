"""TensorBoard summary writer: scalars, text and images.

The port's copy of the JAX package's ``utils/tb_writer.py`` (the reference
logs through ``torch.utils.tensorboard.SummaryWriter``, reference
command_handlers/train_or_resume.py:176-177,498-510).  It writes event
files with the ``tensorboard`` package's protobufs and record framing, so
runs open in standard TensorBoard.  The file is written here, record by
record and flushed after each, rather than through tensorboard's
``EventFileWriter``, which imports TensorFlow wherever it is installed
(seconds of start-up for nothing).  Where ``tensorboard`` does not import,
the scalars and texts go to ``events.jsonl`` in the log directory instead
(images are dropped): only the log's format changes.
"""

import io
import itertools
import json
import os
import socket
import time

import numpy as np

try:
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.proto.summary_pb2 import Summary, SummaryMetadata
    from tensorboard.compat.proto.tensor_pb2 import TensorProto
    from tensorboard.compat.proto.tensor_shape_pb2 import TensorShapeProto
    from tensorboard.summary.writer.record_writer import RecordWriter
    HAVE_TENSORBOARD = True
except ImportError:
    HAVE_TENSORBOARD = False

JSONL_FILE = 'events.jsonl'
_FILE_IDS = itertools.count()   # two writers of one directory in one second differ


class SummaryWriter:
    """The part of torch's ``SummaryWriter`` the engine uses: add_scalar,
    add_text, add_image, flush, close; a context manager."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        if HAVE_TENSORBOARD:
            # tensorboard's own file name and first record (EventFileWriter)
            name = 'events.out.tfevents.{:010d}.{}.{}.{}'.format(
                int(time.time()), socket.gethostname(), os.getpid(), next(_FILE_IDS))
            self._writer = RecordWriter(open(os.path.join(log_dir, name), 'wb'))
            self._write(Event(wall_time=time.time(), file_version='brain.Event:2'))
        else:
            self._writer = None
            self._jsonl = open(os.path.join(log_dir, JSONL_FILE), 'a')

    def _write(self, event):
        self._writer.write(event.SerializeToString())
        self._writer.flush()

    def _add_event(self, summary, step):
        self._write(Event(wall_time=time.time(), step=int(step), summary=summary))

    def add_scalar(self, tag, value, global_step):
        if self._writer is None:
            self._jsonl.write(json.dumps({'tag': tag, 'value': float(value),
                                          'step': int(global_step)}) + '\n')
            return
        self._add_event(Summary(value=[Summary.Value(tag=tag, simple_value=float(value))]),
                        global_step)

    def add_text(self, tag, text, global_step):
        if self._writer is None:
            self._jsonl.write(json.dumps({'tag': tag, 'text': text,
                                          'step': int(global_step)}) + '\n')
            return
        metadata = SummaryMetadata(plugin_data=SummaryMetadata.PluginData(plugin_name='text'))
        tensor = TensorProto(dtype='DT_STRING', string_val=[text.encode('utf-8')],
                             tensor_shape=TensorShapeProto(dim=[TensorShapeProto.Dim(size=1)]))
        self._add_event(Summary(value=[Summary.Value(tag=tag + '/text_summary',
                                                     metadata=metadata, tensor=tensor)]),
                        global_step)

    def add_image(self, tag, img_chw, global_step):
        """``img_chw``: (3, H, W) uint8 (or (1, H, W), or (H, W, C))."""
        if self._writer is None:
            return
        from PIL import Image
        arr = np.asarray(img_chw)
        if arr.ndim == 3 and arr.shape[0] in (1, 3):
            arr = np.transpose(arr, (1, 2, 0))
        if arr.ndim == 3 and arr.shape[2] == 1:
            arr = arr[..., 0]   # PIL encodes grayscale as a 2-D 'L' image
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8)).save(buf, format='PNG')
        image = Summary.Image(height=arr.shape[0], width=arr.shape[1],
                              colorspace=arr.shape[2] if arr.ndim == 3 else 1,
                              encoded_image_string=buf.getvalue())
        self._add_event(Summary(value=[Summary.Value(tag=tag, image=image)]), global_step)

    def flush(self):
        (self._jsonl if self._writer is None else self._writer).flush()

    def close(self):
        (self._jsonl if self._writer is None else self._writer).close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, exc_traceback):
        self.close()
