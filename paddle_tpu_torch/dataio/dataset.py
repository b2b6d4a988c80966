"""Datasets: file ingestion for ``Executor.train_from_dataset``.

A trimmed copy of ``paddle_tpu/dataio/dataset.py``: the same classes,
line format, batching, slab grouping and resumable iterator. Text lines
are whitespace-separated ``name:v1,v2,...`` groups (the reference's
MultiSlotDataFeed), or whatever a ``set_line_parser`` function reads.

Not ported, and raising ``NotImplementedError``: the native C++ feed
(``set_use_native(True)``), ``set_pipe_command``, ``set_hdfs_config``
and ``global_shuffle`` (fleet). One process reads every file of the
list (the JAX package shards the list over processes). Each collated
batch crosses the fault point ``dataio.producer``.
"""
import random

import numpy as np

from ..resilience import maybe_fail


class PositionedBatchIterator:
    """Batch/slab iterator with a resumable cursor. ``position()``
    reports how much of the stream the consumer has received (a batch
    counts when it, or the slab holding it, is yielded):

    - ``epoch``: the epoch index this iterator was created for
    - ``batches``: batches consumed so far, the skipped prefix included;
      pass it back as ``position={"batches": n}`` to resume
    - ``slabs``: slabs (or batches, unslabbed) yielded this epoch
    - ``skipped``: batches parsed and dropped to reach the resume point
    - ``shuffle_seed``: the dataset's shuffle seed at creation
    """

    def __init__(self, raw_batches, slab=None, epoch=0, skip_batches=0,
                 shuffle_seed=None):
        # slab=1 still slabs: the consumer asked for run_steps-shaped
        # dicts with a leading step axis
        self._slab = int(slab) if slab else 0
        self._epoch = int(epoch)
        self._shuffle_seed = shuffle_seed
        self._skipped = 0
        for _ in range(int(skip_batches)):
            if next(raw_batches, None) is None:
                break
            self._skipped += 1
        self._batches = self._skipped
        self._slabs = 0
        self._it = (DatasetBase._slab_batches(raw_batches, self._slab)
                    if self._slab >= 1 else raw_batches)

    def __iter__(self):
        return self

    def __next__(self):
        out = next(self._it)
        if self._slab >= 1:
            self._batches += int(np.shape(next(iter(out.values())))[0])
        else:
            self._batches += 1
        self._slabs += 1
        return out

    def position(self):
        return {"epoch": self._epoch, "batches": self._batches,
                "slabs": self._slabs, "skipped": self._skipped,
                "shuffle_seed": self._shuffle_seed}


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        return QueueDataset()


class DatasetBase:
    def __init__(self):
        self.filelist = []
        self.batch_size = 1
        self.thread_num = 1
        self.use_vars = []
        self.line_parser = None
        self._seed = 0

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_thread(self, thread_num):
        self.thread_num = thread_num

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, cmd):
        raise NotImplementedError("paddle_tpu_torch: set_pipe_command is "
                                  "not ported; use set_line_parser")

    def set_line_parser(self, fn):
        """fn(line) -> tuple of per-var numpy values (one sample)."""
        self.line_parser = fn

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise NotImplementedError("paddle_tpu_torch: HDFS is not ported; "
                                  "local paths only")

    # ---- parsing ----
    def _parse_line(self, line):
        if self.line_parser is not None:
            return self.line_parser(line)
        sample = []
        groups = dict(g.split(":", 1) for g in line.split())
        for var in self.use_vars:
            vals = groups[var.name].split(",")
            dt = np.int64 if "int" in var.dtype else np.float32
            sample.append(np.asarray([dt(v) for v in vals], dtype=dt))
        return tuple(sample)

    def _iter_files(self, files):
        for path in files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield self._parse_line(line)

    def _batches(self, samples):
        names = [v.name for v in self.use_vars]
        buf = []
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                maybe_fail("dataio.producer")
                yield self._collate(names, buf)
                buf = []
        if buf:
            maybe_fail("dataio.producer")
            yield self._collate(names, buf)

    def _positioned(self, it, slab, position):
        """With ``position`` the stream is a
        :class:`PositionedBatchIterator` (skipping the consumed prefix);
        without it, a plain iterator (of slabs when ``slab`` > 1)."""
        if position is not None:
            return PositionedBatchIterator(
                iter(it), slab=slab,
                epoch=position.get("epoch", 0),
                skip_batches=position.get("batches", 0),
                shuffle_seed=position.get("shuffle_seed",
                                          getattr(self, "_seed", None)))
        if slab and slab > 1:
            return self._slab_batches(it, int(slab))
        return it

    @staticmethod
    def _collate(names, buf):
        return {n: np.stack([s[i] for s in buf]) for i, n in enumerate(names)}

    @staticmethod
    def _slab_batches(batches, k):
        """Group consecutive same-shape batches into slabs: dicts with a
        new leading axis of up to ``k`` steps (``Executor.run_steps``'s
        feed). Every shape change flushes the open slab early, so slabs
        stay homogeneous: a fixed-shape stream has only a short tail."""
        buf, sig = [], None
        for b in batches:
            # batch values may be plain lists or scalars
            s = {n: (np.shape(a), str(getattr(a, "dtype", "")))
                 for n, a in b.items()}
            if buf and s != sig:
                yield DatasetBase._stack_slab(buf)
                buf = []
            sig = s
            buf.append(b)
            if len(buf) == k:
                yield DatasetBase._stack_slab(buf)
                buf = []
        if buf:
            yield DatasetBase._stack_slab(buf)

    @staticmethod
    def _stack_slab(buf):
        return {n: np.stack([np.asarray(b[n]) for b in buf])
                for n in buf[0]}


class QueueDataset(DatasetBase):
    """Streaming: parse and batch on the fly, in Python."""

    def set_use_native(self, flag):
        if flag:
            raise NotImplementedError("paddle_tpu_torch: the native C++ "
                                      "feed is not ported")

    def batch_iterator(self, slab=None, position=None):
        it = self._batches(self._iter_files(self.filelist))
        return self._positioned(it, slab, position)


class InMemoryDataset(DatasetBase):
    """Load once, shuffle in memory."""

    def __init__(self):
        super().__init__()
        self._samples = []

    def load_into_memory(self):
        self._samples = list(self._iter_files(self.filelist))

    def local_shuffle(self):
        random.Random(self._seed).shuffle(self._samples)
        self._seed += 1

    def global_shuffle(self, fleet=None, thread_num=None, spool_dir=None):
        raise NotImplementedError("paddle_tpu_torch: global_shuffle (fleet) "
                                  "is not ported; use local_shuffle")

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._samples)

    def batch_iterator(self, slab=None, position=None):
        it = self._batches(iter(self._samples))
        return self._positioned(it, slab, position)
