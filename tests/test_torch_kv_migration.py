"""Port KV export and import (disaggregated prefill and decode) on the
CPU: a slot's blocks out of one pool, over the port's wire and into
another, bitwise for fp32, bf16 and int8 (tests/test_serving_fleet.py);
the payload format shared with the JAX package both ways (a JAX payload
decodes in the port the JAX package's greedy tokens, and the reverse);
geometry refusals; and the split across two servers equal to colocated
paged serving."""
import socket

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.serving.kvpool import KVBlockPool as JPool
from paddle_tpu_torch.distributed.wire import recv_frame, send_frame
from paddle_tpu_torch.flags import flag, set_flags
from paddle_tpu_torch.serving import (BadRequestError, Client,
                                      InferenceServer, KVBlockPool,
                                      KVPoolExhaustedError)
from paddle_tpu_torch.serving.kvpool import KV_WIRE_FMT
from torch_tiny_gpt import MAX_LEN, prompts, tiny_pair

DTYPES = ["fp32", "bf16", "int8"]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _pool(dtype, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("d_head", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 8)
    return KVBlockPool(dtype=dtype, device="cpu", **kw)


def _fill_random(pool, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for t in pool.tensors():
        t.copy_((torch.randn(t.shape, generator=gen) * 3.0).to(t.dtype))


def _over_the_wire(obj):
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname())
    b, _ = lst.accept()
    try:
        send_frame(a, obj, None)
        return recv_frame(b, None)
    finally:
        a.close()
        b.close()
        lst.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kv_export_wire_import_roundtrip_bitwise(dtype):
    """Export a slot, send it in a real wire frame, import it into a
    second pool and export again: every array (int8 scales included) is
    bit-identical, and both pools' accounting balances."""
    src, dst = _pool(dtype), _pool(dtype)
    src.alloc(1, 13)
    _fill_random(src)
    payload = src.export_slot(1)
    assert payload["fmt"] == KV_WIRE_FMT and payload["nblocks"] == 2
    want = {"fp32": np.float32, "bf16": np.uint16, "int8": np.int8}[dtype]
    assert payload["k_0"].dtype == want
    if dtype == "int8":
        assert payload["ks_1"].dtype == np.float32
    wired = _over_the_wire(payload)
    n = dst.import_slot(2, wired)
    assert n == payload["nblocks"] == dst.blocks_in_use()
    back = dst.export_slot(2)
    assert set(back) == set(payload)
    for key, val in payload.items():
        if isinstance(val, np.ndarray):
            assert val.dtype == back[key].dtype
            assert np.array_equal(val, back[key]), (dtype, key)
        else:
            assert back[key] == val, (dtype, key)
    assert KVBlockPool.payload_bytes(payload) == sum(
        a.nbytes for a in payload.values() if isinstance(a, np.ndarray))
    dst.free_slot(2)
    assert dst.blocks_in_use() == 0 and dst.holders() == {}
    assert (src.counters["blocks_exported"], dst.counters["blocks_imported"]) \
        == (2, 2)


def test_kv_import_validates_geometry_and_capacity():
    """A payload of another geometry is refused terminally
    (BadRequest); an exhausted pool refuses retryably with nothing
    allocated."""
    src = _pool("fp32")
    src.alloc(0, 10)
    _fill_random(src)
    payload = src.export_slot(0)
    for bad in (_pool("fp32", block_size=16), _pool("bf16")):
        with pytest.raises(BadRequestError):
            bad.import_slot(0, payload)
        assert bad.blocks_in_use() == 0
    for field, val in (("nblocks", 777), ("fmt", "kvblocks0")):
        with pytest.raises(BadRequestError):
            _pool("fp32").import_slot(0, dict(payload, **{field: val}))
    with pytest.raises(BadRequestError, match="k_1"):
        _pool("fp32").import_slot(0, dict(
            payload, k_1=payload["k_1"].astype(np.float64)))
    tiny = _pool("fp32", num_blocks=2)
    with pytest.raises(KVPoolExhaustedError):
        tiny.import_slot(0, payload)
    assert tiny.blocks_in_use() == 0 and tiny.holders() == {}
    with pytest.raises(ValueError, match="no blocks"):
        _pool("fp32").export_slot(3)


def _geometry(tgen, dtype):
    cfg = tgen.cfg
    return dict(slots=1, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                d_head=cfg.d_head, max_seq_len=MAX_LEN, block_size=16,
                dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_payload_decodes_in_the_port_and_back(pair, dtype):
    """A JAX ``export_slot`` payload (JAX prefill), over the port's wire,
    imports into the port's pool and decodes the JAX package's greedy
    tokens; a port payload imports into a JAX pool and decodes the
    port's."""
    tgen, jgen, _ = pair
    prompt = prompts(tgen.cfg.vocab_size, [9], seed=12)[0]
    n_new = 7
    tokens, pos_ids, last = tgen._pack_prompts([prompt])
    s = tokens.shape[1]
    key = jax.random.PRNGKey(0)

    # JAX prefill -> port decode
    jpool = JPool(name=f"mig_j2t_{dtype}", **_geometry(tgen, dtype))
    logits, caches, key = jgen._run_prefill(tokens, pos_ids, last, key)
    jpool.alloc(0, prompt.size)
    jpool.scatter_prefill([0], caches, s)
    payload = _over_the_wire(jpool.export_slot(0))
    tpool = KVBlockPool(device="cpu", **_geometry(tgen, dtype))
    tpool.import_slot(0, payload)
    got = [int(np.argmax(np.asarray(logits)[0]))]
    pos = prompt.size
    while len(got) < n_new:
        tpool.ensure(0, pos)
        got.append(int(tgen.decode(np.array([got[-1]]), np.array([pos]),
                                   np.zeros(1, np.float32),
                                   np.zeros(1, np.int32), tpool)[0]))
        pos += 1
    want = jgen.generate([prompt], max_new_tokens=n_new, paged=True,
                         kv_dtype=dtype)[0]
    np.testing.assert_array_equal(got, want)

    # port prefill -> JAX decode
    logits, ks, vs = tgen.run_prefill(tokens, pos_ids, last)
    tpool = KVBlockPool(device="cpu", **_geometry(tgen, dtype))
    tpool.alloc(0, prompt.size)
    tpool.scatter_prefill([0], ks, vs, s)
    jpool = JPool(name=f"mig_t2j_{dtype}", **_geometry(tgen, dtype))
    jpool.import_slot(0, tpool.export_slot(0))
    got = [int(torch.argmax(logits[0]))]
    pos = np.array([prompt.size], np.int32)
    while len(got) < n_new:
        jpool.ensure(0, int(pos[0]))
        out, key = jgen._run_decode_paged(np.array([got[-1]], np.int32),
                                          pos, jpool, key)
        got.append(int(np.argmax(np.asarray(out)[0])))
        pos += 1
    want = tgen.generate([prompt], max_new_tokens=n_new, paged=True,
                         kv_dtype=dtype)[0]
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def kv_flags():
    saved = {"kv_cache_dtype": flag("kv_cache_dtype")}
    yield
    set_flags(saved)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_disaggregated_split_matches_colocated(pair, kv_flags, dtype):
    """Prefill on one server, the KV blocks over the wire into another
    server's pool, greedy decode there: token for token the colocated
    paged server's output. Both pools drain to zero and the
    kv_exports/kv_imports counters move; a payload that does not cover
    the prompt is refused at the door."""
    tgen, _, _ = pair
    set_flags({"kv_cache_dtype": dtype})
    prompt = prompts(tgen.cfg.vocab_size, [9], seed=23)[0]
    colo = InferenceServer(generator=tgen, decode_slots=2, paged=True)
    pre = InferenceServer(generator=tgen, decode_slots=2, paged=True)
    dec = InferenceServer(generator=tgen, decode_slots=2, paged=True)
    servers = [colo.start(), pre.start(), dec.start()]
    try:
        with Client(colo.endpoint) as c:
            ref = c.generate(prompt, max_new_tokens=8)
        with Client(pre.endpoint) as cp, Client(dec.endpoint) as cd:
            kv = cp.prefill(prompt, max_new_tokens=8)
            assert kv["prompt_tokens"] == prompt.size
            assert kv["first_token"] == ref[0]
            out = cd.generate(prompt, max_new_tokens=8, kv=kv)
            with pytest.raises(BadRequestError):
                cd.generate(prompt[:4], max_new_tokens=4, kv=kv)
        np.testing.assert_array_equal(out, ref)
        sp, sd = pre.stats(), dec.stats()
        assert sp["kv_exports"] == 1 and sd["kv_imports"] == 1
        assert sp["kvpool_blocks_in_use"] == 0
        assert sd["kvpool_blocks_in_use"] == 0
        assert sd["kvpool_blocks_imported"] == kv["nblocks"]
    finally:
        for srv in servers:
            srv.stop()


def test_prefill_requires_the_paged_pool(pair):
    tgen, _, _ = pair
    srv = InferenceServer(generator=tgen, decode_slots=2,
                          paged=False).start()
    try:
        with Client(srv.endpoint) as c:
            with pytest.raises(BadRequestError, match="paged"):
                c.prefill(prompts(tgen.cfg.vocab_size, [6])[0])
    finally:
        srv.stop()
