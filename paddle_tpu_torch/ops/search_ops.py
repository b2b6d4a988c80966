"""Beam-search ops in torch (counterpart of
``paddle_tpu/ops/extra_ops.py``: ``beam_search :473``, ``gather_tree
:501``, ``select_input :638``; and ``utility_ops.py``:
``beam_search_decode :406``), padded form: every step keeps a static
[B, beam] shape.

``beam_search`` ranks the B x (beam * V) continuations with a stable
descending sort, so equal scores keep the lower flat index first, the
order ``lax.top_k`` gives (``torch.topk`` promises none among ties on
CUDA): the selected ids equal the JAX package's."""
import torch

from ..framework.registry import register_op
from .common import x_of


def topk_lower_index_first(x, k):
    """(values, indices) of the k largest along the last dim, ties
    broken by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search", grad=False, infer_shape=False)
def beam_search(ctx, ins, attrs):
    """One beam expansion: pre_ids / pre_scores [B, beam], scores
    [B*beam, V] log-probs -> the top ``beam_size`` continuations of each
    batch row (selected_ids, selected_scores, parent_idx, [B, beam]). A
    finished beam (pre_id == end_id) continues only with end_id, at its
    own score."""
    pre_ids = x_of(ins, "pre_ids")
    pre_scores = x_of(ins, "pre_scores")
    scores = x_of(ins, "scores")
    beam = int(attrs["beam_size"])
    end_id = int(attrs.get("end_id", 0))
    B, V = pre_ids.shape[0], scores.shape[-1]
    sc = scores.reshape(B, beam, V)
    finished = (pre_ids == end_id)[..., None]
    frozen = torch.full_like(sc, -1e30)
    frozen[:, :, end_id] = pre_scores
    total = torch.where(finished, frozen, pre_scores[..., None] + sc)
    top_s, top_i = topk_lower_index_first(total.reshape(B, beam * V), beam)
    return {"selected_ids": (top_i % V).to(torch.int32),
            "selected_scores": top_s,
            "parent_idx": (top_i // V).to(torch.int32)}


def _back_trace(ids, parents):
    """Walk the parent links back from the last step: ids/parents [T, B,
    beam] -> the full sequences [T, B, beam] (int32)."""
    ids, parents = ids.long(), parents.long()
    T = ids.shape[0]
    beam_idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], -1, beam_idx)
        beam_idx = torch.gather(parents[t], -1, beam_idx)
    return torch.stack(toks).to(torch.int32)


@register_op("gather_tree", grad=False, infer_shape=False)
def gather_tree(ctx, ins, attrs):
    """Back-trace beam parents into sequences: Ids/Parents [T, B, beam]
    -> Out [T, B, beam]."""
    return {"Out": _back_trace(x_of(ins, "Ids"), x_of(ins, "Parents"))}


@register_op("beam_search_decode", grad=False, infer_shape=False)
def beam_search_decode(ctx, ins, attrs):
    """The final gather of a beam search: Ids/ParentIdx/Scores [T, B,
    beam] -> SentenceIds [B, beam, T] and SentenceScores [B, beam] (the
    last step's cumulative log-probs)."""
    sent = _back_trace(x_of(ins, "Ids"), x_of(ins, "ParentIdx"))
    return {"SentenceIds": sent.permute(1, 2, 0),
            "SentenceScores": x_of(ins, "Scores")[-1]}


@register_op("select_input")
def select_input(ctx, ins, attrs):
    """One of N same-shaped inputs, picked by the scalar Mask (clamped
    into range)."""
    xs = list(ins["X"])
    mask = x_of(ins, "Mask").reshape(-1)[0].long().clamp(0, len(xs) - 1)
    return {"Out": torch.stack(xs).index_select(0, mask.reshape(1))[0]}
