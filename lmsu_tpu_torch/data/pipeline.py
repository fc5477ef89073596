"""Host input pipeline: batching, shuffling, padding, prefetch (numpy only).

The port's own copy of lmsu_tpu/data/pipeline.py's Batcher, PrefetchLoader
and make_loader: the same batches in the same order for the same seed and
epoch (tests/test_torch_data.py pins it).

  * Fixed shapes always: the final partial batch is padded to batch_size by
    repeating its first sample, with a per-sample `sample_mask` (1 real, 0
    pad) and all-ignored (-1) labels on the pads, so loss and metrics stay
    exact.
  * `sample_index` carries each row's dataset index.
  * A daemon thread prefetches batches while the device computes.
  * Data parallelism (parallel/mesh.py, one process a device): batch_size
    stays the GLOBAL batch size, every process computes the same global
    order and decodes only its stripe of each global batch, rows
    [shard*B/num_shards, (shard+1)*B/num_shards), padding and sample_mask
    included; make_loader takes the stripe from the active mesh.
  * `materialize_dataset` stacks the whole set for the on-device epoch
    (TrainConfig.onchip_epoch), padded as the Batcher pads.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class Batcher:
    """Iterates a dataset in shuffled, fixed-shape, padded batches. The
    order of epoch e is a shuffle by SeedSequence([seed, e]). With
    num_shards > 1 it yields shard_index's stripe of every global batch of
    batch_size rows; sample_index and sample_mask are made globally, then
    sliced, so the stripes of all shards concatenate to the one-process
    batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_shards: int = 1, shard_index: int = 0,
                 decode_workers: int = 0, sample_transform=None):
        if batch_size % num_shards != 0:
            raise ValueError(f"global batch_size {batch_size} not divisible "
                             f"by num_shards {num_shards}")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"{num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        # Per-sample decode threads (0/1 = inline on the producer thread).
        self.decode_workers = decode_workers
        # Per-sample post-decode transform, e.g. data/rasterize.py::
        # make_point_sorter for the sorted-input scatter kernel.
        self.sample_transform = sample_transform
        self._pool = None
        self._epoch = 0

    def _get(self, i):
        s = self.dataset[int(i)]
        return self.sample_transform(s) if self.sample_transform else s

    def _decode(self, indices):
        if self.decode_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.decode_workers)
            return list(self._pool.map(self._get, indices))
        return [self._get(i) for i in indices]

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch])).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        B = self.batch_size
        L = B // self.num_shards  # this shard's rows of each global batch
        lo, hi = self.shard_index * L, (self.shard_index + 1) * L
        for start in range(0, len(order), B):
            chunk = order[start:start + B]
            if len(chunk) < B and self.drop_last:
                return
            n_real = len(chunk)
            if n_real < B:  # pad by repeating the first sample
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], B - n_real)])
            mask = np.arange(B) < n_real
            chunk, mask = chunk[lo:hi], mask[lo:hi]  # decode only this stripe
            samples = self._decode(chunk)
            batch: Dict[str, np.ndarray] = {}
            for key in samples[0]:
                if key == "sample_token":
                    continue
                batch[key] = np.stack([s[key] for s in samples])
            batch["sample_index"] = chunk.astype(np.int32)
            batch["sample_mask"] = mask
            batch["segmentation"] = np.where(mask[:, None, None], batch["segmentation"], -1)
            yield batch


class PrefetchLoader:
    """Wraps a Batcher with a daemon producer thread (bounded queue)."""

    def __init__(self, batcher: Batcher, prefetch: int = 2):
        self.batcher = batcher
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.batcher)

    def set_epoch(self, epoch: int) -> None:
        self.batcher.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in self.batcher:
                    if not put(b):
                        return  # the consumer abandoned the epoch
                put(end)
            except BaseException as e:  # surfaced to the consumer below
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Early break: release the producer thread.
            stop.set()


def materialize_dataset(dataset, batch_size: int,
                        sample_transform=None) -> Dict[str, np.ndarray]:
    """The whole dataset stacked into fixed-shape arrays, padded to a
    multiple of batch_size, for the on-device epoch (the JAX package's
    materialize_dataset, pipeline.py:179-206): `sample_transform` is applied
    to every sample (the cell sorter under sorted_pallas: dropping it would
    give wrong answers silently); pad rows repeat sample 0 with
    segmentation -1 (all ignored), sample_index 0 and sample_mask 0, the
    masking contract the Batcher keeps."""
    n = len(dataset)
    n_pad = (n + batch_size - 1) // batch_size * batch_size
    samples = [dataset[i] for i in range(n)]
    if sample_transform is not None:
        samples = [sample_transform(s) for s in samples]
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        if key == "sample_token":
            continue
        arr = np.stack([s[key] for s in samples])
        if n_pad > n:
            arr = np.concatenate([arr, np.repeat(arr[:1], n_pad - n, axis=0)])
        out[key] = arr
    out["sample_index"] = np.concatenate([np.arange(n, dtype=np.int32),
                                          np.zeros(n_pad - n, np.int32)])
    out["sample_mask"] = np.arange(n_pad) < n
    out["segmentation"] = np.where(out["sample_mask"][:, None, None], out["segmentation"], -1)
    return out


def make_loader(dataset, batch_size: int, shuffle: bool, seed: int = 0,
                drop_last: bool = False, prefetch: int = 2,
                num_shards: Optional[int] = None, shard_index: Optional[int] = None,
                decode_workers: int = 0, sample_transform=None) -> PrefetchLoader:
    """The prefetching loader over a Batcher. num_shards / shard_index
    default to the active mesh's (world size, rank), so each rank of a
    data-parallel run decodes only its stripe (one process: 1 / 0)."""
    if num_shards is None or shard_index is None:
        from lmsu_tpu_torch.parallel.mesh import process_data_stripes
        n, i = process_data_stripes()
        num_shards = n if num_shards is None else num_shards
        shard_index = i if shard_index is None else shard_index
    return PrefetchLoader(Batcher(dataset, batch_size, shuffle, seed, drop_last,
                                  num_shards=num_shards, shard_index=shard_index,
                                  decode_workers=decode_workers,
                                  sample_transform=sample_transform), prefetch)
