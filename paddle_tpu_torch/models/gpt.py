"""GPT-style causal language model for generation: pre-LN decoder blocks
with a weight-tied LM head, as one ``nn.Module`` with three inference
entry points.

Counterpart of ``paddle_tpu/models/gpt.py``. The JAX package builds a
static program per mode (``gpt_prefill``, ``gpt_decode_step``,
``gpt_decode_step_paged``); here they are the methods :meth:`GPT.prefill`,
:meth:`GPT.decode_step` and :meth:`GPT.decode_step_paged` of one module
over one set of parameters with the JAX scope names
(``word_embedding``, ``decoder_layer_{i}_qkv.w_0``, ...). Layer norm has
eps 1e-5, GELU is the exact erf form, ``fc`` is ``x @ W[in, out] + b``
and the head is ``h @ word_embedding.T``.

Attention per mode: prefill runs the flash-attention kernel (causal),
the dense decode step the plain masked read of
:func:`ops.decode_ops.kv_cached_attention`, and the paged decode step
the paged-attention kernel over the shared block pool.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from ..ops.decode_ops import (kv_cache_write, kv_cached_attention,
                              paged_kv_cache_write, row_gather)


class GPTConfig:
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=3072, max_position=2048,
                 dropout=0.1, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.max_position = max_position
        self.dropout = dropout
        self.initializer_range = initializer_range

    @property
    def d_head(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=128, hidden_size=32, num_layers=1,
                   num_heads=2, ffn_size=64, max_position=64, dropout=0.0)


def param_shapes(cfg):
    """{JAX scope name: shape} of every parameter, in build order."""
    h, f = cfg.hidden_size, cfg.ffn_size
    shapes = {"word_embedding": (cfg.vocab_size, h),
              "pos_embedding": (cfg.max_position, h)}
    for i in range(cfg.num_layers):
        pre = f"decoder_layer_{i}"
        for name, (fin, fout) in (("qkv", (h, 3 * h)), ("att_out", (h, h)),
                                  ("ffn_0", (h, f)), ("ffn_1", (f, h))):
            shapes[f"{pre}_{name}.w_0"] = (fin, fout)
            shapes[f"{pre}_{name}.b_0"] = (fout,)
        for ln in ("pre_att_ln", "pre_ffn_ln"):
            shapes[f"{pre}_{ln}_scale"] = (h,)
            shapes[f"{pre}_{ln}_bias"] = (h,)
    shapes["final_ln_scale"] = (h,)
    shapes["final_ln_bias"] = (h,)
    return shapes


def params_from_jax(cfg, arrays):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}``,
    checked against :func:`param_shapes`: raises on a missing, extra or
    mis-shaped name."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"GPT parameters do not match the config: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for name, shape in want.items():
        a = arrays[name]
        t = a.detach().to(torch.float32, copy=True) \
            if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"GPT parameter {name!r} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        out[name] = t
    return out


def init_params(cfg, seed=0):
    """Seeded random parameters with the JAX startup's initializers:
    ``Normal(0, initializer_range)`` weights and embeddings, zero biases,
    unit layer-norm scales. Float32 CPU tensors."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_scale"):
            out[name] = torch.ones(shape)
        elif name.endswith("_bias") or name.endswith(".b_0"):
            out[name] = torch.zeros(shape)
        else:
            out[name] = torch.empty(shape).normal_(
                0.0, cfg.initializer_range, generator=gen)
    return out


def _attr(name):
    return name.replace(".", "__")


class GPT(nn.Module):
    """Inference GPT over ``params`` (``{JAX scope name: tensor}``) on
    ``device`` (None -> CUDA; raises without a GPU)."""

    def __init__(self, cfg, params, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        params = params_from_jax(cfg, params)
        for name, t in params.items():
            self.register_parameter(_attr(name), nn.Parameter(
                t.to(self.device), requires_grad=False))

    def param(self, name):
        """Parameter by its JAX scope name."""
        return getattr(self, _attr(name))

    # -- pieces -----------------------------------------------------------
    def _embed(self, tokens, pos_ids):
        return F.embedding(tokens, self.param("word_embedding")) \
            + F.embedding(pos_ids, self.param("pos_embedding"))

    def _ln(self, x, name):
        return F.layer_norm(x, (self.cfg.hidden_size,),
                            self.param(f"{name}_scale"),
                            self.param(f"{name}_bias"), eps=1e-5)

    def _fc(self, x, name):
        return torch.matmul(x, self.param(f"{name}.w_0")) \
            + self.param(f"{name}.b_0")

    def _layer(self, i, x, attend):
        """Pre-LN block: x + attn(LN(x)); x + ffn(LN(x)). ``attend(q, k,
        v)`` takes and returns ``[B, H, S, D]``."""
        cfg = self.cfg
        B, S, h = x.shape
        pre = f"decoder_layer_{i}"
        qkv = self._fc(self._ln(x, f"{pre}_pre_att_ln"), f"{pre}_qkv")
        q, k, v = (t.view(B, S, cfg.num_heads, cfg.d_head).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
        ctx = attend(q, k, v).transpose(1, 2).reshape(B, S, h)
        x = x + self._fc(ctx, f"{pre}_att_out")
        f = self._ln(x, f"{pre}_pre_ffn_ln")
        f = F.gelu(self._fc(f, f"{pre}_ffn_0"), approximate="none")
        return x + self._fc(f, f"{pre}_ffn_1")

    def _next_logits(self, x, last_pos):
        """final-LN hidden [B, S, H] -> logits [B, V] at each row's
        ``last_pos`` (tied head)."""
        h = row_gather(self._ln(x, "final_ln"), last_pos)
        return torch.matmul(h, self.param("word_embedding").t())

    # -- entry points -----------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, pos_ids, last_pos):
        """Causal forward over a right-padded prompt batch. tokens/pos_ids
        ``[B, S]``, last_pos ``[B]`` -> ``(logits [B, V], ks, vs)`` with
        ``ks[i]``/``vs[i]`` the layer's fresh keys/values ``[B, H, S, D]``
        (position 0 onward; padded positions hold garbage that position
        masks never read)."""
        x = self._embed(tokens, pos_ids)
        ks, vs = [], []

        def attend(q, k, v):
            ks.append(k)
            vs.append(v)
            return flash_attention(q, k, v, causal=True)

        for i in range(self.cfg.num_layers):
            x = self._layer(i, x, attend)
        return self._next_logits(x, last_pos), ks, vs

    @torch.no_grad()
    def decode_step(self, token, pos, cache_k, cache_v):
        """One incremental step over the dense bank: token/pos ``[B]``,
        ``cache_k[i]``/``cache_v[i]`` ``[B, H, L, D]`` (updated in place
        at ``pos``) -> logits ``[B, V]``."""
        x = self._embed(token[:, None], pos[:, None])
        for i in range(self.cfg.num_layers):
            def attend(q, k, v, i=i):
                kv_cache_write(cache_k[i], k, pos)
                kv_cache_write(cache_v[i], v, pos)
                return kv_cached_attention(q, cache_k[i], cache_v[i], pos)
            x = self._layer(i, x, attend)
        return self._next_logits(x, torch.zeros_like(pos))

    @torch.no_grad()
    def decode_step_paged(self, token, pos, tables, pools):
        """One incremental step over the shared block pool: token/pos
        ``[B]`` int, tables ``[B, nblk]`` int32, ``pools[i]`` the layer's
        ``(k_pool, v_pool, k_scale, v_scale)`` (scales None unless int8;
        updated in place) -> logits ``[B, V]``."""
        pos32 = pos.to(torch.int32)
        x = self._embed(token[:, None], pos[:, None])
        for i in range(self.cfg.num_layers):
            pk, pv, pks, pvs = pools[i]

            def attend(q, k, v, pk=pk, pv=pv, pks=pks, pvs=pvs):
                paged_kv_cache_write(pk, k, tables, pos, scale=pks)
                paged_kv_cache_write(pv, v, tables, pos, scale=pvs)
                return paged_attention(q.contiguous(), pk, pv, tables,
                                       pos32, k_scale=pks, v_scale=pvs)
            x = self._layer(i, x, attend)
        return self._next_logits(x, torch.zeros_like(pos))
