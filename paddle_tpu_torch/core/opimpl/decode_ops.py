"""TensorArray and beam-search decode ops (the port's
``paddle_tpu/core/opimpl/decode_ops.py``; ref
``operators/controlflow/tensor_array_read_write_op.cc``,
``beam_search_op.cc``, ``beam_search_decode_op.cc``).

As in the reference, an array is a fixed-capacity stacked buffer
[capacity, ...] and a beam is a dense [B, K] tensor. Its fill level rides
beside it in the env as ``<array>@LEN`` (a 0-d int32 tensor), which
``while_block`` carries through the loop. Every op stays on the device:
the write index, the fill level and the decode length are tensors, never
read on the host.
"""

import torch

from ..op_registry import get, put, register


def _index(env, op, cap):
    """The op's ``I`` as a [1] long tensor clamped into [0, cap), as
    ``lax.dynamic_update_index_in_dim`` / ``dynamic_index_in_dim`` clamp
    it."""
    i = get(env, op.input("I")).reshape(1).long()
    return i.clamp(0, cap - 1)


@register("array_write")
def _array_write(env, op):
    """Write X at index I of the array (created zeroed, ``capacity`` slots,
    on first write), out of place; Out is the array var itself, so a write
    inside a While body updates the loop carry. The fill level becomes
    max(level, I + 1)."""
    x = get(env, op.input("X"))
    arr_var = op.output("Out")
    arr = env.get(arr_var.name)
    if arr is None:
        arr = torch.zeros((op.attr("capacity"),) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
    i = get(env, op.input("I")).reshape(()).to(torch.int32)
    put(env, arr_var, arr.index_copy(0, _index(env, op, arr.shape[0]),
                                     x.to(arr.dtype).unsqueeze(0)))
    key = arr_var.name + "@LEN"
    level = env.get(key)
    env[key] = i + 1 if level is None else torch.maximum(level, i + 1)


@register("array_read")
def _array_read(env, op):
    arr = get(env, op.input("Array"))
    put(env, op.output("Out"),
        arr.index_select(0, _index(env, op, arr.shape[0])).squeeze(0))


@register("array_length")
def _array_length(env, op):
    """1 + the highest index written so far (the reference's growing
    LoDTensorArray); the capacity for an array no op wrote."""
    name = op.input("Array").name
    n = env.get(name + "@LEN")
    if n is None:
        n = torch.tensor(env[name].shape[0], dtype=torch.int32,
                         device=env[name].device)
    put(env, op.output("Out"), n.to(torch.int32))


def top_k_stable(x, k):
    """The k largest along the last axis, and their indices, equal values
    in index order (``lax.top_k``'s order; ``torch.topk`` orders ties
    arbitrarily): a stable descending sort, cut at k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_candidates(pre_ids, pre_scores, scores, end_id):
    """The scores [B, K * V] of every extension of every beam: PreIds/
    PreScores [B, K], Scores [B, K, V] log-probs. A finished beam (last
    id == end_id) extends only by end_id, at zero added score, so its
    score is frozen."""
    b, k, v = scores.shape
    end_row = torch.where(torch.arange(v, device=scores.device) == end_id,
                          0.0, -1e9).to(scores.dtype)
    cont = torch.where((pre_ids == end_id).unsqueeze(-1), end_row, scores)
    return (pre_scores.unsqueeze(-1) + cont).reshape(b, k * v)


@register("beam_search_step")
def _beam_search_step(env, op):
    """One pruning step: keep the global top K of the K * V extensions
    (:func:`beam_candidates`) of each batch item. SelectedIds/
    SelectedScores/ParentIdx [B, K]."""
    pre_ids = get(env, op.input("PreIds"))
    scores = get(env, op.input("Scores"))
    k, v = scores.shape[1], scores.shape[2]
    top_scores, top_idx = top_k_stable(beam_candidates(
        pre_ids, get(env, op.input("PreScores")), scores, op.attr("end_id")),
        k)
    put(env, op.output("SelectedIds"), (top_idx % v).to(pre_ids.dtype))
    put(env, op.output("SelectedScores"), top_scores)
    put(env, op.output("ParentIdx"), (top_idx // v).to(torch.int32))


def gather_beams(x, idx):
    """``out[b, j] = x[b, idx[b, j]]`` for x [B, K, ...], idx [B, K]."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2])
                                         + tuple(x.shape[2:])))


@register("beam_search_gather")
def _beam_search_gather(env, op):
    """Reorder per-beam state X [B, K, ...] by parent index Ids [B, K]."""
    put(env, op.output("Out"), gather_beams(get(env, op.input("X")),
                                            get(env, op.input("Ids"))))


@register("beam_search_decode")
def _beam_search_decode(env, op):
    """Backtrack the recorded (ids, parents) arrays [T, B, K] into
    sentences: SentenceIds [B, K, T] (steps at or past Length are end_id),
    SentenceScores the final beam scores as they are. The walk runs from
    the last slot to the first on the device (the reference's reverse
    ``lax.scan``): slot t gives beam j's token at t and the beam it came
    from; past Length a beam stays itself."""
    ids_arr = get(env, op.input("IdsArray"))
    par_arr = get(env, op.input("ParentsArray"))
    length = get(env, op.input("Length")).reshape(())
    end_id = op.attr("end_id")
    t_cap, b, k = ids_arr.shape
    beam = torch.arange(k, device=ids_arr.device).expand(b, k)
    toks = [None] * t_cap
    for t in range(t_cap - 1, -1, -1):
        live = length > t
        tok = torch.gather(ids_arr[t], 1, beam)
        parent = torch.gather(par_arr[t], 1, beam).long()
        toks[t] = torch.where(live, tok, torch.full_like(tok, end_id))
        beam = torch.where(live, parent, beam)
    put(env, op.output("SentenceIds"), torch.stack(toks, dim=-1))
    put(env, op.output("SentenceScores"), get(env, op.input("FinalScores")))
