"""Port serving path on the CPU: KV block-pool allocator invariants
(the applicable cases of tests/test_kvpool.py), the prefill scatter, the
wire framing, the continuous-batching InferenceServer over loopback
against offline generate, and the port's import hygiene and no-fallback
rules."""
import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
from paddle_tpu_torch.serving import (Client, InferenceServer, KVBlockPool,
                                      KVPoolExhaustedError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pool(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("d_head", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("device", "cpu")
    return KVBlockPool(**kw)


# -- allocator ---------------------------------------------------------------

def test_alloc_grows_and_free_returns_everything():
    p = _pool(num_blocks=9)                   # 8 allocatable + trash
    assert p.capacity_blocks == 8
    assert p.alloc(0, 1) == 1                 # first token -> 1 block
    assert p.alloc(0, 8) == 0                 # same block covers 8
    assert p.alloc(0, 9) == 1                 # 9th token opens block 2
    assert p.blocks_in_use() == 2
    assert all(b > 0 for b in p.tables[0, :2])
    assert all(b == 0 for b in p.tables[0, 2:])
    assert p.free_slot(0) == 2
    assert p.free_slot(0) == 0                # idempotent
    assert p.blocks_in_use() == 0
    assert (p.tables == 0).all()


def test_alloc_exhaustion_is_typed_and_leaves_state_untouched():
    p = _pool(num_blocks=4)                   # 3 allocatable
    p.alloc(0, 16)                            # 2 blocks
    tables, in_use = p.tables.copy(), p.blocks_in_use()
    with pytest.raises(KVPoolExhaustedError) as ei:
        p.alloc(1, 17)                        # needs 3, 1 free
    assert (ei.value.needed, ei.value.free, ei.value.capacity) == (3, 1, 3)
    assert isinstance(ei.value, serving.ServerOverloadedError)
    assert p.blocks_in_use() == in_use
    np.testing.assert_array_equal(p.tables, tables)
    p.free_slot(0)
    assert p.alloc(1, 17) == 3                # retry after frees works


def test_check_fits_and_admission_check():
    p = _pool(num_blocks=4)                   # 24-token capacity
    p.check_fits(24)
    with pytest.raises(serving.BadRequestError, match="never"):
        p.check_fits(25)
    p = _pool(num_blocks=9)                   # 8 allocatable
    p.admission_check(32, pending_tokens=[32])       # 4 + 4 == 8 free
    with pytest.raises(KVPoolExhaustedError):
        p.admission_check(33, pending_tokens=[32])   # 5 + 4 > 8
    assert p.blocks_in_use() == 0             # the gate allocates nothing


def test_stats_occupancy_and_fragmentation():
    p = _pool(num_blocks=9, block_size=8)
    p.alloc(0, 9)                 # 2 blocks for 9 tokens: 7 slack slots
    st = p.stats()
    assert st["capacity_blocks"] == 8 and st["blocks_in_use"] == 2
    assert st["occupancy"] == pytest.approx(0.25)
    assert st["fragmentation"] == pytest.approx(1 - 9 / 16)
    assert st["tokens_held"] == 9 and st["slots_holding_blocks"] == 1
    assert st["bytes_in_use"] == 2 * p.block_bytes()


def test_pool_config_validation():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _pool(dtype="fp16")
    with pytest.raises(ValueError, match="trash"):
        _pool(num_blocks=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_scatter_prefill_lays_rows_out_by_block_table(dtype):
    """Row r's position t lands at (tables[r, t // bs], :, t % bs);
    positions past the allocation go to the trash block only."""
    p = _pool(slots=2, num_layers=1, num_blocks=9, dtype=dtype)
    p.alloc(0, 5)                             # 1 block
    p.alloc(1, 11)                            # 2 blocks
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.normal(size=(2, 2, 16, 8)).astype(np.float32))
    v = k + 1.0
    p.scatter_prefill([0, 1], [k], [v], 16)
    pk, pv, pks, pvs = p.layers()[0]

    def read(pool, sc, b):
        x = pool[b].float()
        return x * sc[b][..., None] if sc is not None else x

    tol = {"fp32": 0, "bf16": 1e-2, "int8": 3e-2}[dtype]
    for r, n in ((0, 5), (1, 11)):
        for t in range(n):
            blk = int(p.tables[r, t // 8])
            np.testing.assert_allclose(read(pk, pks, blk)[:, t % 8],
                                       k[r, :, t], atol=tol)
            np.testing.assert_allclose(read(pv, pvs, blk)[:, t % 8],
                                       v[r, :, t], atol=tol)
    held = {int(b) for b in p.tables[p.tables > 0]}
    untouched = [b for b in range(1, 9) if b not in held]
    assert untouched and all(float(pk[b].float().abs().sum()) == 0
                             for b in untouched)


# -- wire ----------------------------------------------------------------

def test_wire_roundtrip_and_hmac():
    msg = {"op": "generate", "tokens": np.arange(5, dtype=np.int32),
           "n": 3, "t": 0.5, "e": None, "flag": True,
           "nested": [1, (2.0, "x")]}
    out = wire.decode(wire.encode(msg))
    np.testing.assert_array_equal(out["tokens"], msg["tokens"])
    assert out["nested"] == (1, (2.0, "x")) and out["e"] is None
    with pytest.raises(wire.WireError):
        wire.encode({"f": object()})
    with pytest.raises(wire.WireError):
        wire.decode(wire.encode(1) + b"x")
    a, b = __import__("socket").socketpair()
    try:
        wire.send_frame(a, {"x": 1}, key=b"k1")
        with pytest.raises(wire.WireError, match="HMAC"):
            wire.recv_frame(b, key=b"k2")
    finally:
        a.close()
        b.close()


# -- the generation server -------------------------------------------------

@pytest.fixture(scope="module")
def gen():
    cfg = GPTConfig.tiny()
    return GPTGenerator(cfg, init_params(cfg, seed=0), max_len=48,
                        bucket_min=8, device="cpu")


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("paged", [True, False])
def test_server_concurrent_clients_match_offline_and_reuse_slots(gen,
                                                                 paged):
    """5 requests from 3 concurrent wire clients through 2 decode slots:
    slots are reused, every reply equals offline greedy generate for its
    prompt, and the pool ends empty."""
    prompts = _prompts(gen.cfg.vocab_size, (5, 9, 3, 12, 7))
    budgets = (6, 4, 8, 5, 7)
    want = [gen.generate([p], max_new_tokens=n)[0]
            for p, n in zip(prompts, budgets)]
    server = InferenceServer(generator=gen, decode_slots=2,
                             paged=paged).start()
    got, errors = {}, []

    def client(idxs):
        try:
            with Client(server.endpoint, timeout=60) as c:
                for i in idxs:
                    got[i] = c.generate(prompts[i], budgets[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(idxs,))
               for idxs in ((0, 3), (1, 4), (2,))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i], w)
        st = Client(server.endpoint).stats()
        assert st["requests_completed"] == 5
        assert st["generate_requests"] == 5
        assert st["tokens_generated"] == sum(budgets)
        assert st["decode_free_slots"] == 2
        if paged:
            assert st["kvpool_blocks_in_use"] == 0
            assert server.gen_engine.pool.blocks_in_use() == 0
    finally:
        server.stop()


def test_server_refuses_overlong_prompt_and_insecure_bind(gen):
    server = InferenceServer(generator=gen, decode_slots=2,
                             paged=True).start()
    try:
        with Client(server.endpoint, timeout=30) as c:
            assert c.ping()
            with pytest.raises(serving.BadRequestError, match="exceeds"):
                c.generate(np.ones(40, np.int32), 20)
            # the server keeps serving after a refusal
            assert c.generate(np.ones(4, np.int32), 3).shape == (3,)
    finally:
        server.stop()
    with pytest.raises(PermissionError, match="non-loopback"):
        InferenceServer(generator=gen, host="0.0.0.0", auth_key=None,
                        decode_slots=1).start()


def test_stop_fails_queued_requests_typed(gen):
    server = InferenceServer(generator=gen, decode_slots=1, paged=True)
    req = server.submit_generate(np.ones(4, np.int32), 3)   # not started
    server.stop()
    with pytest.raises(serving.ServerShutdownError):
        req.wait(timeout=5)


# -- import hygiene and no fallback ----------------------------------------

def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "profile_torch_decode.py")
    yield os.path.join(REPO, "tools", "profile_torch_train.py")


def test_port_imports_neither_jax_nor_paddle_tpu():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.framework, paddle_tpu_torch.layers, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.models.gpt; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_cuda_instead_of_using_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTGenerator(cfg, init_params(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVBlockPool(slots=2, num_layers=1, num_heads=2, d_head=8,
                    max_seq_len=16, block_size=8)
    import paddle_tpu_torch as fluid
    for place in (None, fluid.CUDAPlace(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fluid.Executor(place)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on any other device than the CPU never reaches the plain
    version: it launches the kernel (CUDA) or raises."""
    from paddle_tpu_torch.kernels import flash_attention_fwd, paged_attention
    q = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q, causal=True)
    tables = torch.empty(1, 2, dtype=torch.int32, device="meta")
    pos = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q[:, :, :1], q, q, tables, pos)
    launches = (flash_attention_fwd.launches, paged_attention.launches)
    flash_attention_fwd(*(torch.zeros(1, 2, 4, 32),) * 3)
    assert (flash_attention_fwd.launches, paged_attention.launches) \
        == launches                          # the CPU path counts nothing
