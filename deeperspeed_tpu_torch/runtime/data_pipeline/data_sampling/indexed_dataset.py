"""Memory-mapped indexed token dataset (Megatron/NeoX format family; a copy
of ``deeperspeed_tpu/runtime/data_pipeline/data_sampling/indexed_dataset.py``,
numpy only).

Equivalent of reference
``runtime/data_pipeline/data_sampling/indexed_dataset.py`` (617 LoC): a
``.bin`` file of concatenated token arrays plus a ``.idx`` sidecar with
per-document dtype/lengths/offsets, read zero-copy through ``np.memmap`` so
a multi-TB corpus costs no resident RAM.  The host-side loader feeds the
device batches; nothing here touches the device.

Format (little-endian):
    idx:  magic b'DSTIDX01' | dtype_code u8 | n_docs u64
          | lengths u32[n_docs] | offsets u64[n_docs]  (byte offsets)
    bin:  raw token data, documents back to back
"""

import os
import struct

import numpy as np

_MAGIC = b"DSTIDX01"
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
           5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
           9: np.uint32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix):
    return prefix + ".bin"


def index_file_path(prefix):
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Append documents, then ``finalize()`` writes the index."""

    def __init__(self, prefix, dtype=np.uint16):
        self._prefix = prefix
        self._dtype = np.dtype(dtype)
        assert self._dtype in _CODES, f"unsupported dtype {dtype}"
        self._bin = open(data_file_path(prefix), "wb")
        self._lengths = []
        self._offsets = []
        self._pos = 0

    def add_item(self, tokens):
        arr = np.ascontiguousarray(tokens, dtype=self._dtype)
        self._offsets.append(self._pos)
        self._lengths.append(arr.size)
        self._bin.write(arr.tobytes())
        self._pos += arr.nbytes

    # reference name
    add_doc = add_item

    def merge_file_(self, other_prefix):
        """Append another dataset's documents (reference ``merge_file_``)."""
        other = MMapIndexedDataset(other_prefix)
        for i in range(len(other)):
            self.add_item(other[i])

    def finalize(self):
        self._bin.close()
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<B", _CODES[self._dtype]))
            f.write(struct.pack("<Q", len(self._lengths)))
            f.write(np.asarray(self._lengths, np.uint32).tobytes())
            f.write(np.asarray(self._offsets, np.uint64).tobytes())


class MMapIndexedDataset:
    """Zero-copy document access: ``ds[i]`` -> np array view of document i."""

    def __init__(self, prefix):
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
            (code,) = struct.unpack("<B", f.read(1))
            (n_docs,) = struct.unpack("<Q", f.read(8))
            self._dtype = np.dtype(_DTYPES[code])
            self._lengths = np.frombuffer(f.read(4 * n_docs), np.uint32)
            self._offsets = np.frombuffer(f.read(8 * n_docs), np.uint64)
        self._data = np.memmap(data_file_path(prefix), dtype=np.uint8, mode="r")
        self._prefix = prefix

    def __len__(self):
        return len(self._lengths)

    @property
    def sizes(self):
        return self._lengths

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        off = int(self._offsets[idx])
        n = int(self._lengths[idx])
        return np.frombuffer(self._data, dtype=self._dtype, count=n, offset=off)

    def get(self, idx, offset=0, length=None):
        """Sub-document read (reference ``get``)."""
        doc = self[idx]
        end = len(doc) if length is None else offset + length
        return doc[offset:end]

    @staticmethod
    def exists(prefix):
        return (os.path.isfile(index_file_path(prefix))
                and os.path.isfile(data_file_path(prefix)))
