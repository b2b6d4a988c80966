"""Datasets of the port (trimmed copy of ``paddle_tpu/dataio``): the
file-backed ``QueueDataset`` and ``InMemoryDataset`` that
``Executor.train_from_dataset`` reads. Readers, loaders and reader
decorators are not ported."""
from .dataset import (DatasetBase, DatasetFactory, InMemoryDataset,
                      PositionedBatchIterator, QueueDataset)

__all__ = ["DatasetBase", "DatasetFactory", "InMemoryDataset",
           "PositionedBatchIterator", "QueueDataset"]
