"""The port's datasets (``paddle_tpu_torch.dataio``) against the JAX
package's (``paddle_tpu.dataio``, its Python path), on the CPU: the
same files give the same batches; slabs group consecutive same-shape
batches with a short tail and flush at a shape change; plain-list batch
values slab as arrays do; ``PositionedBatchIterator`` resumes where a
position says; ``InMemoryDataset`` loads, shuffles and releases as the
JAX one does; what is not ported raises."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.dataio.dataset import DatasetBase as JBase
from paddle_tpu_torch.dataio.dataset import DatasetBase as TBase


def _files(tmp_path, n=21):
    rng = np.random.RandomState(0)
    paths = []
    for f in range(2):
        lines = []
        for _ in range(n // 2 + f):
            ids = rng.randint(0, 50, 3)
            w = rng.randn(2).astype(np.float32)
            lines.append(f"ids:{','.join(map(str, ids))} "
                         f"w:{','.join(map(repr, w.tolist()))}")
        p = tmp_path / f"f{f}.txt"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


def _dataset(fluid, paths, kind="QueueDataset", batch=4):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        ids = fluid.data("ids", [-1, 3], "int64")
        w = fluid.data("w", [-1, 2], "float32")
    ds = fluid.DatasetFactory().create_dataset(kind)
    if kind == "QueueDataset" and fluid is jfluid:
        ds.set_use_native(False)
    ds.set_filelist(paths)
    ds.set_batch_size(batch)
    ds.set_use_var([ids, w])
    return ds


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for n in x:
            assert x[n].dtype == y[n].dtype and np.array_equal(x[n], y[n])


@pytest.mark.parametrize("slab", [None, 1, 4])
def test_batches_and_slabs_equal_jax(tmp_path, slab):
    paths = _files(tmp_path)
    j = list(_dataset(jfluid, paths).batch_iterator(slab=slab))
    t = list(_dataset(tfluid, paths).batch_iterator(slab=slab))
    _same(j, t)
    if slab == 4:
        # 21 samples in batches of 4: 5 full batches and one of 1 -> a
        # slab of 4, then the 5th batch alone (the shape change flushes
        # it), then the short batch
        assert [len(s["ids"]) for s in t] == [4, 1, 1]
        assert t[0]["ids"].shape == (4, 4, 3)
        assert t[2]["ids"].shape == (1, 1, 3)


def test_plain_list_values_slab_as_arrays():
    batches = [{"a": [1.0, 2.0], "b": 3} for _ in range(5)]
    j = list(JBase._slab_batches(iter(batches), 2))
    t = list(TBase._slab_batches(iter(batches), 2))
    _same(j, t)
    assert [s["a"].shape for s in t] == [(2, 2), (2, 2), (1, 2)]


def test_positioned_iterator_resumes(tmp_path):
    paths = _files(tmp_path)
    full = list(_dataset(tfluid, paths).batch_iterator())
    it = _dataset(tfluid, paths).batch_iterator(position={"batches": 0})
    first = [next(it) for _ in range(2)]
    pos = it.position()
    assert pos["batches"] == 2 and pos["slabs"] == 2
    rest = list(_dataset(tfluid, paths).batch_iterator(position=pos))
    _same(first + rest, full)
    jit = _dataset(jfluid, paths).batch_iterator(position={"batches": 3},
                                                 slab=2)
    tit = _dataset(tfluid, paths).batch_iterator(position={"batches": 3},
                                                 slab=2)
    _same(list(jit), list(tit))
    assert tit.position() == jit.position()


def test_in_memory_dataset_equals_jax(tmp_path):
    paths = _files(tmp_path)
    j = _dataset(jfluid, paths, "InMemoryDataset", batch=5)
    t = _dataset(tfluid, paths, "InMemoryDataset", batch=5)
    for ds in (j, t):
        ds.load_into_memory()
        ds.local_shuffle()
    assert t.get_memory_data_size() == j.get_memory_data_size() == 21
    _same(list(j.batch_iterator(slab=2)), list(t.batch_iterator(slab=2)))
    t.release_memory()
    assert list(t.batch_iterator()) == []


def test_what_is_not_ported_raises(tmp_path):
    ds = _dataset(tfluid, _files(tmp_path))
    for call in (lambda: ds.set_use_native(True),
                 lambda: ds.set_pipe_command("cat"),
                 lambda: ds.set_hdfs_config("hdfs://x", "u,p"),
                 lambda: tfluid.DatasetFactory().create_dataset(
                     "InMemoryDataset").global_shuffle()):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError):
        tfluid.Executor(tfluid.CPUPlace()).train_from_dataset(
            tfluid.Program(), ds, fetch_handler=object())
