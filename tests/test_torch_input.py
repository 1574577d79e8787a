"""The port's host input side against the JAX package's, on the CPU at the
conftest's 64x128 frames: the raw pair cache (data/raw_cache.py), the
native batched decode (data/native.py), the loaders' batch-level read and
priming (data/pipeline.py, data/transforms.py), and ``train`` and
``benchmark`` with ``DSRL_TPU_RAW_CACHE``.

* An entry written by either package's ``RawPairCache`` has the other's
  file name and loads in the other bit for bit; touching a source misses, a
  truncated entry misses and is removed, a store of another geometry does
  nothing.
* The native decode equals the port's PIL reader and the JAX package's
  native decode bit for bit; a missing file and a frame of another size
  raise and name the pair; a failed build prints one CAUTION with the
  compiler's message and the loaders decode with PIL; a batch the native
  decode fails on is decoded again with PIL, with one CAUTION.
* The train loader gives the JAX ``Loader(use_native=False)``'s batches
  over two epochs, with and without the cache (cold, then warm, decoding
  only the pairs epoch 1 did not read) and with 0 and 2 worker processes;
  the eval loader likewise, with its pad mask.  Priming stores every pair
  of an epoch's shard once.
* ``train`` with the cache writes the ``final.weights`` of the run without
  it and prints the priming INFO line; ``benchmark`` with the cache writes
  the ``outputs/benchmark.txt`` of the run without it (its ``On:`` time
  stamp aside).

Every cache directory and work tree lies under the test's ``tmp_path`` and
is deleted in teardown.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.data import (
    CityscapesDataset as JaxDataset, Loader as JaxLoader, RawPairCache as JaxRawPairCache)
from dualsuperreslearningforsemseg_tpu.data import native as jax_native
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
from dualsuperreslearningforsemseg_tpu_torch.data import (
    CityscapesDataset, RawPairCache, make_eval_loader, make_synthetic_cityscapes_tree,
    make_train_loader, native, prime_raw_cache)

HW = (64, 128)
CPU = torch.device('cpu')


@pytest.fixture
def work(tmp_path):
    """tmp_path, deleted with everything under it when the test ends."""
    try:
        yield tmp_path
    finally:
        shutil.rmtree(str(tmp_path), ignore_errors=True)


@pytest.fixture
def tree(work):
    root = str(work / 'data')
    make_synthetic_cityscapes_tree(root, split='train', num_images=7, size_hw=HW, seed=3)
    make_synthetic_cityscapes_tree(root, split='val', num_images=5, size_hw=HW, seed=4)
    return root


@pytest.fixture
def cache_env(work, monkeypatch):
    """Points DSRL_TPU_RAW_CACHE at an empty directory; returns its path."""
    path = str(work / 'cache')
    monkeypatch.setenv('DSRL_TPU_RAW_CACHE', path)
    return path


def _pair(rng):
    return (rng.integers(0, 256, HW + (3,), dtype=np.uint8),
            rng.integers(0, 34, HW, dtype=np.uint8))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_a_cache_entry_of_either_package_loads_in_the_other(tree, work, writer):
    img_path, seg_path = CityscapesDataset(tree, 'train').pairs[0]
    jax_cache = JaxRawPairCache(str(work / 'cache'), HW)
    port_cache = RawPairCache(str(work / 'cache'), HW)
    write, read = (jax_cache, port_cache) if writer == 'jax' else (port_cache, jax_cache)
    img, seg = _pair(np.random.default_rng(0))
    write.store(img_path, seg_path, img, seg)
    assert os.listdir(str(work / 'cache')) == \
        [os.path.basename(port_cache._entry_path(img_path, seg_path))]
    assert port_cache._entry_path(img_path, seg_path) == jax_cache._entry_path(img_path, seg_path)
    assert read.has(img_path, seg_path)
    got_img, got_seg = read.load(img_path, seg_path)
    np.testing.assert_array_equal(got_img, img)
    np.testing.assert_array_equal(got_seg, seg)


@pytest.mark.parametrize('fault', ['touched_source', 'truncated_entry', 'bad_magic',
                                   'foreign_geometry'])
def test_stale_and_bad_entries_miss(tree, work, fault):
    img_path, seg_path = CityscapesDataset(tree, 'train').pairs[0]
    cache = RawPairCache(str(work / 'cache'), HW)
    img, seg = _pair(np.random.default_rng(1))
    if fault == 'foreign_geometry':
        cache.store(img_path, seg_path, img[:32], seg[:32])
        assert os.listdir(cache.dir) == []
        return
    cache.store(img_path, seg_path, img, seg)
    entry = cache._entry_path(img_path, seg_path)
    if fault == 'touched_source':
        st = os.stat(img_path)
        os.utime(img_path, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
        assert not cache.has(img_path, seg_path) and cache.load(img_path, seg_path) is None
        assert os.path.isfile(entry)   # orphaned, not served
        return
    with open(entry, 'r+b') as f:
        if fault == 'truncated_entry':
            f.truncate(os.path.getsize(entry) - 1)
        else:
            f.write(b'DSRLRAW1')
    assert cache.load(img_path, seg_path) is None
    assert not os.path.exists(entry)


def test_native_decode_equals_pil_and_the_jax_native_decode(tree):
    ds = CityscapesDataset(tree, 'train')
    img_paths, seg_paths = [p[0] for p in ds.pairs], [p[1] for p in ds.pairs]
    imgs, segs = native.decode_pair_batch(img_paths, seg_paths, HW, threads=3)
    assert imgs.shape == (7,) + HW + (3,) and segs.shape == (7,) + HW
    for i in range(len(ds)):
        img, seg = ds[i]
        np.testing.assert_array_equal(imgs[i], img)
        np.testing.assert_array_equal(segs[i], seg)
    assert jax_native.native_available()
    jax_imgs, jax_segs = jax_native.decode_pair_batch(img_paths, seg_paths, HW, threads=3)
    np.testing.assert_array_equal(imgs, jax_imgs)
    np.testing.assert_array_equal(segs, jax_segs)
    assert os.path.dirname(native.get_lib()._name) == native.BUILD_DIR


@pytest.mark.parametrize('fault', ['missing_file', 'wrong_size'])
def test_native_decode_names_the_failing_pair(tree, work, fault):
    pairs = CityscapesDataset(tree, 'train').pairs[:3]
    img_paths, seg_paths = [p[0] for p in pairs], [p[1] for p in pairs]
    if fault == 'missing_file':
        seg_paths[1] = str(work / 'missing_gtFine_labelIds.png')
        message = 'code 1 (open failed)'
    else:
        small = str(work / 'small')
        make_synthetic_cityscapes_tree(small, split='train', num_images=1, size_hw=(32, 128))
        img_paths[1], seg_paths[1] = CityscapesDataset(small, 'train').pairs[0]
        message = 'code 7 (unexpected dimensions)'
    with pytest.raises(RuntimeError, match=re.escape(message)) as info:
        native.decode_pair_batch(img_paths, seg_paths, HW)
    assert "on pair ({!r}, {!r})".format(img_paths[1], seg_paths[1]) in str(info.value)


def test_a_failed_build_says_why_and_the_loader_decodes_with_pil(tree, work, monkeypatch,
                                                                  capsys):
    broken = work / 'broken.cpp'
    broken.write_text('int dp_version( {\n')
    monkeypatch.setattr(native, 'SOURCE', str(broken))
    monkeypatch.setattr(native, 'BUILD_DIR', str(work / 'build'))
    native._load.cache_clear()
    try:
        assert native.get_lib() is None
        out = capsys.readouterr().out
        assert 'Native data plane unavailable (g++ exited 1: ' in out and 'error' in out
        assert 'falling back to PIL decode' in out
        loader = make_train_loader(CityscapesDataset(tree, 'train'), 2, 0, CPU, seed=5)
        assert loader.dataset.native_hw is None
        assert not os.listdir(str(work / 'build'))
        _assert_train_batches_equal(list(_epochs(loader, (1,))), _jax_train_batches(tree, (1,)))
    finally:
        native._load.cache_clear()


def test_a_batch_the_native_decode_fails_on_is_decoded_again_with_pil(tree, monkeypatch,
                                                                       capsys):
    def failing(*args, **kwargs):
        raise RuntimeError("native decode failed with code 3 (decode failed)")

    loader = make_train_loader(CityscapesDataset(tree, 'train'), 2, 0, CPU, seed=5)
    assert loader.dataset.native_hw == HW
    monkeypatch.setattr(native, 'decode_pair_batch', failing)
    got = list(_epochs(loader, (1,)))
    assert capsys.readouterr().out.count('native batch decode failed') == 1
    _assert_train_batches_equal(got, _jax_train_batches(tree, (1,)))


def _epochs(loader, epochs):
    for epoch in epochs:
        loader.batch_sampler.set_epoch(epoch)
        yield from loader


def _jax_train_batches(root, epochs, batch_size=2):
    loader = JaxLoader(JaxDataset(root, split='train'), batch_size=batch_size, shuffle=True,
                       seed=5, drop_last=True, num_workers=2, use_native=False)
    batches = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        batches += [(imgs, segs, epoch, b) for b, (imgs, segs) in enumerate(loader)]
    return batches


def _assert_train_batches_equal(got, want):
    assert len(got) == len(want)
    for (imgs, segs, epoch, b), (ref_imgs, ref_segs, ref_epoch, ref_b) in zip(got, want):
        assert (epoch, b) == (ref_epoch, ref_b)
        assert imgs.dtype == torch.uint8 and segs.dtype == torch.uint8
        np.testing.assert_array_equal(imgs.numpy(), ref_imgs)
        np.testing.assert_array_equal(segs.numpy(), ref_segs)


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('cached', [False, True])
def test_train_loader_gives_the_jax_loaders_batches(tree, work, monkeypatch, cached, workers):
    if cached:
        monkeypatch.setenv('DSRL_TPU_RAW_CACHE', str(work / 'cache'))
    loader = make_train_loader(CityscapesDataset(tree, 'train'), 2, workers, CPU, seed=5)
    assert loader.dataset.native_hw == HW
    assert (loader.dataset.raw_cache is not None) == cached
    assert loader.dataset.native_threads == max(1, os.cpu_count() // max(1, workers))
    want = _jax_train_batches(tree, (1, 2))
    # 7 frames in batches of 2: each epoch reads 6; epoch 2 misses only the
    # pairs epoch 1 dropped, and decodes once for each batch holding one.
    read = [[int(i) for i in loader.batch_sampler.sampler.indices_for_epoch(e)[:6]]
            for e in (1, 2)]
    misses = [i for i in read[1] if i not in read[0]]
    miss_batches = len({read[1].index(i) // 2 for i in misses})
    calls = native.decode_pair_batch.calls
    cold = list(_epochs(loader, (1,)))
    if cached:
        assert len(os.listdir(str(work / 'cache'))) == 6
    if workers == 0:
        assert native.decode_pair_batch.calls == calls + 3
        calls = native.decode_pair_batch.calls
    warm = list(_epochs(loader, (2,)))
    if cached:
        assert len(os.listdir(str(work / 'cache'))) == 6 + len(misses)
    if workers == 0:
        assert native.decode_pair_batch.calls == calls + (miss_batches if cached else 3)
    _assert_train_batches_equal(cold + warm, want)


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('cached', [False, True])
def test_eval_loader_gives_the_jax_loaders_batches_and_pad_mask(tree, work, monkeypatch, cached,
                                                                 workers):
    if cached:
        monkeypatch.setenv('DSRL_TPU_RAW_CACHE', str(work / 'cache'))
    for rank in (0, 1) if workers == 0 else (1,):   # rank 1 holds the pad entry
        want = list(JaxLoader(JaxDataset(tree, split='val'), batch_size=2, shuffle=False,
                              drop_last=False, num_workers=2, world_size=2, rank=rank,
                              use_native=False))
        for _ in range(2 if cached else 1):   # cold, then warm
            got = list(make_eval_loader(CityscapesDataset(tree, 'val'), 2, workers, CPU, 2, rank))
            assert len(got) == len(want) == 2
            for (imgs, segs, valid), (ref_imgs, ref_segs, ref_valid) in zip(got, want):
                np.testing.assert_array_equal(imgs.numpy(), ref_imgs)
                np.testing.assert_array_equal(segs.numpy(), ref_segs)
                assert valid.dtype == torch.float32
                np.testing.assert_array_equal(valid.numpy(), ref_valid)
    if cached:
        assert len(os.listdir(str(work / 'cache'))) == (5 if workers == 0 else 3)


def test_priming_stores_an_epochs_shard_once(tree, cache_env, monkeypatch):
    train = make_train_loader(CityscapesDataset(tree, 'train'), 2, 0, CPU, seed=5,
                              world_size=2, rank=1)
    shard = set(int(i) for i in train.batch_sampler.sampler.indices_for_epoch(1))
    first = prime_raw_cache(train, epoch=1, background=False)
    assert (first['primed'], first['skipped']) == (len(shard), 0) and first['seconds'] > 0
    cache = train.dataset.raw_cache
    pairs = train.dataset.dataset.pairs
    assert [i for i in range(len(pairs)) if cache.has(*pairs[i])] == sorted(shard)
    again = prime_raw_cache(train, epoch=1, background=False)
    assert (again['primed'], again['skipped']) == (0, len(shard))

    val = make_eval_loader(CityscapesDataset(tree, 'val'), 2, 0, CPU, 2, 1)
    thread = prime_raw_cache(val)
    thread.join(timeout=60)
    assert not thread.is_alive() and thread.daemon
    # Rank 1 of 2 over 5 frames: 1, 3 and the pad entry standing for 0.
    assert thread.stats['primed'] == 3 and len(os.listdir(cache_env)) == len(shard) + 3

    monkeypatch.delenv('DSRL_TPU_RAW_CACHE')
    plain = make_train_loader(CityscapesDataset(tree, 'train'), 2, 0, CPU, seed=5)
    assert plain.dataset.raw_cache is None and prime_raw_cache(plain, epoch=1) is None


TRAIN = ['train', '--device', 'cpu', '--stage', '1', '--epochs', '1', '--batch-size', '2',
         '--num-workers', '0', '--dataset', 'cityscapes', '--val-interval', '1']


def test_train_and_benchmark_with_the_cache_give_the_results_without_it(work, monkeypatch,
                                                                        capsys):
    data_root = os.path.join(str(work), 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=4, size_hw=HW, seed=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=3, size_hw=HW, seed=2)
    monkeypatch.chdir(work)
    monkeypatch.delenv('DSRL_TPU_RAW_CACHE', raising=False)
    plain = main(TRAIN + ['--experiment-id', 'plain'])
    assert 'Priming raw pair cache' not in capsys.readouterr().out
    monkeypatch.setenv('DSRL_TPU_RAW_CACHE', str(work / 'cache'))
    cached = main(TRAIN + ['--experiment-id', 'cached'])
    out = capsys.readouterr().out
    assert "Priming raw pair cache for the 'train' split in the background." in out
    assert "Priming raw pair cache for the 'val' split in the background." in out
    assert len(os.listdir(str(work / 'cache'))) == 7
    assert 0 <= cached['primed_before_first_step'] <= 4 + 3
    assert [len(e['input_waits']) for e in cached['epochs']] == [2]
    want = load_checkpoint_or_weights(plain['final_weights'])['model_state_dict']
    got = load_checkpoint_or_weights(cached['final_weights'])['model_state_dict']
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    def benchmark_txt():
        main(['benchmark', '--weights', plain['final_weights'], '--dataset', 'cityscapes', 'val',
              '--device', 'cpu', '--num-workers', '0', '--batch-size', '2'])
        with open(os.path.join('outputs', 'benchmark.txt')) as f:
            return re.sub(r'(?m)^On: .*$', 'On:', f.read())

    with_cache = benchmark_txt()
    monkeypatch.delenv('DSRL_TPU_RAW_CACHE')
    assert benchmark_txt() == with_cache
    assert 'mIoU %: ' in with_cache
