"""The split-KV walk of the paged decode kernel (K5,
``paddle_tpu_torch/kernels/csrc/paged_attention.cu``) on the CPU.

The kernel runs only on the GPU (chip_smoke.py holds it against its plain
version there). Here: its split plan (``split_plan``, which sizes the
grid), a float32 model of its walk in PyTorch, held against the port's
plain version and against the JAX package's Pallas kernel in interpret
mode, and what the wrapper takes and refuses. The model follows the
kernel's layout (the tiles of a split, the token groups of a tile, the
groups' merge, the merge of a row's splits in a fixed order) but is not
its code: it checks the arithmetic of that layout and the split plan,
not the kernel's instructions, which only the GPU runs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")
tpa = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")

_LOG2E = 1.4426950408889634
_NEG_BIG = -1e30
# the merge kernel's split groups: thread y folds splits y, y + 8, ...,
# then the groups' sums add up in y order (MSG in paged_attention.cu)
_MERGE_GROUPS = 8


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _tile(elem, D):
    """(token groups of a CTA, slots of a tile) as ``Plan`` in
    paged_attention.cu sizes them: 128 threads, each reading a 16-byte
    vector of a token row (8 bytes for int8) and folding 4 slots of a
    tile; slot t of a tile belongs to group t % groups."""
    vec = 8 if elem == 1 else 16
    groups = 128 // (D // (vec // elem))
    return groups, 4 * groups


def _fold_split(q2, kp, vp, ks, vs, blocks, h, t_begin, t_end, bs, tile):
    """One split's walk: its live slots [t_begin, t_end) in tiles, each
    group folding its slots of a tile (the max, one rescale, then p * v),
    then the groups' states merged -> (m, l, acc) of the split."""
    groups, tt = tile
    D = q2.shape[0]
    slots = torch.arange(t_begin, t_end)
    blk = torch.as_tensor(blocks)[slots // bs - t_begin // bs]
    within = slots % bs
    k, v = kp[blk, h, within].float(), vp[blk, h, within].float()
    s2 = k @ q2
    vsc = torch.ones(len(slots))
    if ks is not None:
        s2, vsc = s2 * ks[blk, h, within], vs[blk, h, within]
    ntiles = -(-len(slots) // tt)
    pad = ntiles * tt - len(slots)
    live = torch.cat([torch.ones(len(slots), dtype=torch.bool),
                      torch.zeros(pad, dtype=torch.bool)])
    shape = (ntiles, tt // groups, groups)     # [tile, slot u, group g]
    s2 = torch.cat([s2, torch.zeros(pad)]).view(shape)
    vsc = torch.cat([vsc, torch.zeros(pad)]).view(shape)
    v = torch.cat([v, torch.zeros(pad, D)]).view(*shape, D)
    live = live.view(shape)
    m, l = torch.full((groups,), _NEG_BIG), torch.zeros(groups)
    acc = torch.zeros(groups, D)
    for i in range(ntiles):
        mt = torch.maximum(m, s2[i].masked_fill(~live[i], -torch.inf)
                           .amax(0))
        corr = torch.exp2(m - mt)
        pr = torch.exp2(s2[i] - mt).masked_fill(~live[i], 0.0)
        l = l * corr + pr.sum(0)
        acc = acc * corr[:, None] + torch.einsum("ug,ugd->gd",
                                                 pr * vsc[i], v[i])
        m = mt
    M = m.max()
    f = torch.exp2(m - M)
    return M, (l * f).sum(), (acc * f[:, None]).sum(0)


def replay(q, kp, vp, tables, pos, ks=None, vs=None, scale=None):
    """The kernel's result, computed in its layout: per (b, h) the live
    splits of ``split_plan``, each walked by :func:`_fold_split` (scores
    in base 2 from q prescaled by scale * log2 e; int8 dots times the
    slot's scale); a row with one live split takes acc / l, one with
    several merges them in the merge kernel's order. Slots past pos are
    never read; a row with nothing visible gives 0."""
    B, H, _, D = q.shape
    bs, nblk = kp.shape[2], tables.shape[1]
    bps, _ = tpa.split_plan(bs, nblk)
    tile = _tile(kp.element_size(), D)
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros(B, H, 1, D, dtype=torch.float32)
    for b in range(B):
        p = int(pos[b])
        last = -1 if p < 0 else min(p // bs, nblk - 1)
        nlive = 0 if last < 0 else last // bps + 1
        for h in range(H):
            q2 = q[b, h, 0].float() * _f32(scale * _LOG2E)
            parts = []
            for s in range(nlive):
                j0, j1 = s * bps, min((s + 1) * bps, last + 1)
                parts.append(_fold_split(
                    q2, kp, vp, ks, vs, tables[b, j0:j1].long(), h,
                    j0 * bs, min(p + 1, j1 * bs), bs, tile))
            if nlive == 1:
                out[b, h, 0] = parts[0][2] / parts[0][1]
            elif nlive > 1:
                M = torch.stack([m for m, _, _ in parts]).max()
                L, O = _f32(0.0), torch.zeros(D)
                for y in range(_MERGE_GROUPS):
                    Ly, Oy = _f32(0.0), torch.zeros(D)
                    for m, l, acc in parts[y::_MERGE_GROUPS]:
                        f = torch.exp2(m - M)
                        Ly, Oy = Ly + l * f, Oy + acc * f
                    L, O = L + Ly, O + Oy
                out[b, h, 0] = O / L
    return out.to(q.dtype)


def _inputs(kv_dtype, bs, pos, seed, H=2, D=32, slots=1024):
    """q, k/v pools (int8 with scales), tables and pos: ``slots`` key
    slots a row, each row's live blocks a random permutation of the pool,
    the trash block 0 past its allocation."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos, np.int32)
    B, nblk = len(pos), slots // bs
    nb = [min(int(p) // bs + 1, nblk) if p >= 0 else 0 for p in pos]
    N = sum(nb) + 1
    tables = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    used = 0
    for b, n in enumerate(nb):
        tables[b, :n] = perm[used:used + n]
        used += n
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    kf = torch.from_numpy(rng.normal(size=(N, H, bs, D)).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=(N, H, bs, D)).astype(np.float32))
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = tpa.quantize_kv(kf), tpa.quantize_kv(vf)
    else:
        dt = getattr(torch, kv_dtype)
        kp, vp, ks, vs = kf.to(dt), vf.to(dt), None, None
    return (torch.from_numpy(q), kp, vp, torch.from_numpy(tables),
            torch.from_numpy(pos), ks, vs)


def _jax(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _edge_pos(bs, slots=1024):
    """pos -1 (nothing visible), 0, the last slot of the first split, the
    first slot of the second, a row with 4 splits ending on a split
    boundary, and the table's last slot."""
    span = tpa.split_plan(bs, slots // bs)[0] * bs
    return [-1, 0, span - 1, span, 4 * span - 1, slots // bs * bs - 1]


@pytest.mark.parametrize("bs", [6, 8, 16, 64, 128])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_split_replay_matches_ref_and_jax_interpret(kv_dtype, bs):
    """The replay against the port's plain version (1e-5: both read the
    same stored values and compute in float32) and against the JAX
    package's Pallas kernel in interpret mode (1e-5; bf16 pools 2e-2, as
    the TPU kernel rounds p to the pool type before p . v). Rows with
    nothing visible are 0, as the TPU kernel gives them (the gather
    composite averages there)."""
    pos = _edge_pos(bs)
    q, kp, vp, t, p, ks, vs = _inputs(kv_dtype, bs, pos, seed=bs)
    bps, nsplit = tpa.split_plan(bs, t.shape[1])
    assert nsplit >= 4 and (p // (bps * bs)).max() >= 3   # many splits
    got = replay(q, kp, vp, t, p, ks, vs)
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    ref = tpa.paged_attention_ref(q, kp, vp, t, p, ks, vs)
    np.testing.assert_allclose(got[1:].numpy(), ref[1:].numpy(), atol=1e-5,
                               rtol=0)
    want = jpa._pallas_paged_attention(
        _jax(q), _jax(kp), _jax(vp), _jax(t), _jax(p), _jax(ks), _jax(vs),
        q.shape[-1] ** -0.5, True)
    tol = 2e-2 if kv_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_split_replay_row_independent_of_batch_and_table_width(kv_dtype):
    """A row's bits do not depend on the batch it rides in or on the
    table's width: the split boundaries are a function of the block index
    alone."""
    pos = _edge_pos(16)
    q, kp, vp, t, p, ks, vs = _inputs(kv_dtype, 16, pos, seed=3)
    batch = replay(q, kp, vp, t, p, ks, vs)
    wide = torch.cat([t, torch.zeros(len(pos), 37, dtype=t.dtype)], 1)
    assert tpa.split_plan(16, wide.shape[1])[0] \
        == tpa.split_plan(16, t.shape[1])[0]
    for r in range(len(pos)):
        sl = slice(r, r + 1)
        alone = replay(q[sl], kp, vp, t[sl], p[sl], ks, vs)
        assert torch.equal(alone, batch[sl])
        assert torch.equal(replay(q[sl], kp, vp, wide[sl], p[sl], ks, vs),
                           batch[sl])


@pytest.mark.parametrize("bs", [1, 8, 16, 24, 128, 256, 1000])
def test_split_plan_covers_the_table_in_fixed_runs(bs):
    for nblk in (1, 7, 64, 2048):
        bps, nsplit = tpa.split_plan(bs, nblk)
        assert bps == max(1, tpa.SPLIT_TOKENS // bs)
        assert (nsplit - 1) * bps < nblk <= nsplit * bps


def test_paged_wrapper_takes_any_block_size_the_bulk_copies_can():
    """The kernel takes any block size, 128 and 6 included, for float32,
    bf16 and int8 pools: a K/V row is a whole number of 16-byte vectors
    and the int8 scales move 4 bytes at a time. It refuses pools that do
    not start on 16 bytes."""
    q = torch.zeros(2, 2, 1, 32)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        for bs in (1, 3, 6, 128):
            kp = torch.zeros(4, 2, bs, 32, dtype=dt)
            tpa._check(q, kp, kp, tables, pos, None, None)
    for bs in (1, 4, 6, 128):
        kp = torch.zeros(4, 2, bs, 32, dtype=torch.int8)
        sc = torch.ones(4, 2, bs)
        tpa._check(q, kp, kp, tables, pos, sc, sc)
    off = torch.zeros(4 * 2 * 8 * 32 + 1)[1:].view(4, 2, 8, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tpa._check(q, off, off, tables, pos, None, None)
