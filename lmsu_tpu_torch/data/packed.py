"""Pre-decoded, memory-mapped dataset packs.

The port's copy of lmsu_tpu/data/packed.py, in the same format, so a pack
written by either package loads in the other. Decode a dataset once
(`python -m lmsu_tpu_torch.prepare_dataset`), write its fixed-shape sample
arrays to disk, and train from a memory-mapped view whose per-sample cost
is a few copies instead of a JPEG and two pickles.

Format (version 1): one directory per split, holding
    meta.json           {"n": N, "keys": [...], "version": 1}
    <key>.npy           [N, ...] array of each sample field (np.save format,
                        loadable with np.load(mmap_mode="r"))
    sample_token.json   list of N tokens (provenance; not batched)

A read copies the sample out of the mapping, so transforms downstream (the
cell sort) never touch the mapping.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

_META = "meta.json"
_TOKENS = "sample_token.json"
_VERSION = 1


def write_pack(dataset, out_dir: str, verbose: bool = False) -> None:
    """Write `dataset` (any mapping-style dataset of fixed-shape sample
    dicts) as a pack under `out_dir`. Samples stream one at a time into
    preallocated memmaps, so a dataset larger than memory packs too."""
    n = len(dataset)
    if n == 0:
        raise ValueError("refusing to pack an empty dataset")
    os.makedirs(out_dir, exist_ok=True)
    first = dataset[0]
    keys = [k for k in first if k != "sample_token"]
    mms: Dict[str, np.memmap] = {}
    for k in keys:
        a = np.asarray(first[k])
        mms[k] = np.lib.format.open_memmap(os.path.join(out_dir, f"{k}.npy"), mode="w+",
                                           dtype=a.dtype, shape=(n,) + a.shape)
    tokens: List[str] = []
    for i in range(n):
        s = dataset[i] if i else first
        for k in keys:
            mms[k][i] = s[k]
        tokens.append(str(s.get("sample_token", i)))
        if verbose and (i + 1) % 256 == 0:
            print(f"  packed {i + 1}/{n}", flush=True)
    for m in mms.values():
        m.flush()
    with open(os.path.join(out_dir, _TOKENS), "w") as f:
        json.dump(tokens, f)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"n": n, "keys": keys, "version": _VERSION}, f)


class PackedDataset:
    """Mapping-style view over a pack: __getitem__(i) -> a dict of numpy
    arrays (copies) and its sample_token, the contract of the other datasets,
    so the Batcher, materialize_dataset and the teacher cache take it as is."""

    def __init__(self, pack_dir: str):
        meta_path = os.path.join(pack_dir, _META)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{pack_dir} is not a dataset pack (no {_META}); write one with "
                f"python -m lmsu_tpu_torch.prepare_dataset")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise ValueError(f"pack version {meta.get('version')} != {_VERSION}")
        self.pack_dir = pack_dir
        self.n = int(meta["n"])
        self.keys = list(meta["keys"])
        self._arrays = {k: np.load(os.path.join(pack_dir, f"{k}.npy"), mmap_mode="r")
                        for k in self.keys}
        for k, a in self._arrays.items():
            if a.shape[0] != self.n:
                raise ValueError(f"pack field {k}: {a.shape[0]} rows, meta says {self.n}")
        with open(os.path.join(pack_dir, _TOKENS)) as f:
            self.tokens = json.load(f)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        out = {k: np.array(a[idx]) for k, a in self._arrays.items()}
        out["sample_token"] = self.tokens[idx]
        return out


def create_packed_datasets(config) -> Tuple[PackedDataset, PackedDataset]:
    """DataConfig.dataset == "packed": `root` holds the train/ and val/
    packs that prepare_dataset writes."""
    return (PackedDataset(os.path.join(config.root, "train")),
            PackedDataset(os.path.join(config.root, "val")))
