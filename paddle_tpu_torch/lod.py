"""Host-side LoD tensor containers (a copy of ``paddle_tpu/lod.py``):
``Tensor``, ``LoDTensor``, ``LoDTensorArray``, ``create_lod_tensor`` and
``create_random_int_lodtensor``.

The device representation of ragged data is masked-dense (padded [B, T,
...] + length vectors); these classes are the host-side feed/fetch
containers that carry recursive_sequence_lengths beside a numpy
payload, so reference user code that builds LoDTensors for feeding runs
unchanged. The executor's feed path takes them through ``__array__``
(the masked-dense ops take the lengths separately)."""
import numpy as np


class Tensor:
    """Host tensor: `t = fluid.Tensor(); t.set(arr, place)` (reference
    pybind core.Tensor)."""

    def __init__(self):
        self._array = None
        self._place = None
        self._recursive_seq_lens = []

    def set(self, array, place=None):
        self._array = np.asarray(array)
        self._place = place

    def shape(self):
        return list(self._array.shape) if self._array is not None else []

    def _dtype(self):
        return str(self._array.dtype) if self._array is not None else None

    def set_recursive_sequence_lengths(self, lens):
        self._recursive_seq_lens = [list(l) for l in (lens or [])]

    def recursive_sequence_lengths(self):
        return self._recursive_seq_lens

    def has_valid_recursive_sequence_lengths(self):
        if not self._recursive_seq_lens:
            return True
        # innermost level must tile the leading dim; outer levels must
        # tile the next level's entry count (reference
        # CheckAbsLoD/CheckLoD)
        levels = self._recursive_seq_lens
        if self._array is None or sum(levels[-1]) != self._array.shape[0]:
            return False
        for outer, inner in zip(levels, levels[1:]):
            if sum(outer) != len(inner):
                return False
        return True

    def __array__(self, dtype=None):
        a = self._array
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self.shape()}, "
                f"recursive_sequence_lengths={self._recursive_seq_lens})")


class LoDTensor(Tensor):
    """reference core.LoDTensor: a Tensor + recursive sequence lengths."""


class LoDTensorArray(list):
    """reference core.LoDTensorArray: a growable list of LoDTensors."""


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Build a LoDTensor from an ndarray / nested list / LoDTensor plus
    level-wise sequence lengths (reference lod_tensor.py:24). A nested
    list of per-sequence rows is flattened; lengths are validated
    against the leading dim."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(np.asarray(data), recursive_seq_lens,
                                 place)
    if isinstance(data, list):
        # list of sequences: flatten rows, derive the innermost level
        flat = [np.asarray(seq).reshape(len(seq), -1) for seq in data]
        new_lens = [len(seq) for seq in data]
        if recursive_seq_lens and \
                list(recursive_seq_lens[-1]) != new_lens:
            raise ValueError(
                "the provided recursive_seq_lens do not match the "
                "sequence lengths of the nested-list data")
        data = np.concatenate(flat, axis=0) if flat else np.zeros((0, 1))
    arr = np.asarray(data)
    t = LoDTensor()
    t.set(arr, place)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(
            f"invalid recursive_seq_lens {recursive_seq_lens} for data "
            f"with leading dim {arr.shape[0]}")
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """Random-int LoDTensor whose leading dim is the sum of the
    innermost lengths (reference lod_tensor.py:114)."""
    n = sum(recursive_seq_lens[-1])
    shape = [n] + list(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
