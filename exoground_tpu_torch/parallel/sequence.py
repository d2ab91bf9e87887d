"""Sequence parallelism: ring attention over the ranks of a process group.

Counterpart of ``exoground_tpu/parallel/sequence.py``. The time axis is
split over the ranks of a ``Mesh`` (``parallel/mesh.py``: NCCL on cards,
gloo on the CPU) and attention runs as a ring: each rank keeps its query
block and passes its K/V block (and its key-padding mask) to the next rank,
``world`` times (``collectives.ring_shift``, the JAX ``ppermute`` with
``perm = [(i, (i + 1) % n)]``), folding each block it holds into an online
softmax (``_fold_block``: running max, sum and accumulator, ``NEG_INF`` on
padded keys) while the next one is on its way. Activation memory per rank is
O(S / world); the score blocks are (S / world)². The folds are cuBLAS
products (the JAX module is XLA einsums; it has no Pallas kernel).

The joint encoder's rows are [video block ⊕ text]: the video K/V ride the
ring while the text block, the same on every rank, folds in once after it
(``extra_k`` / ``extra_v`` / ``extra_mask``), so every rank holds the whole
text output. ``sequence_parallel_sim`` computes the global-mode dual and
joint similarities of a ``TemporalAligner`` that way (reference
eval/eval_zeroshot_align.py:205-216): the projections, LayerNorms and MLPs
are position-wise and run on the rank's rows, each encoder layer's
self-attention on the ring, its MLP through the block's ``MLP`` module (the
fused MLP kernel on a card under 'auto'). S pads up to a multiple of the
world inside and the padding is key-masked; the position embedding is built
for the real length and zero-padded.

At world 1, with a process group or without one, the ring has one block
and the rotation passes it as it is, as ``ppermute`` does on a one-device
axis.

Two differences from the JAX functions, by design:

  * ``sequence_parallel_sim``, ``sequence_parallel_dual_sim`` and
    ``sequence_sharded_self_attention`` take the global tensors on every
    rank and return the global result on every rank (the rank's blocks are
    gathered), as the JAX functions take and return the global arrays of
    their ``shard_map``. ``ring_attention`` is the per-rank body: it takes
    and returns this rank's blocks, as the JAX function does inside
    ``shard_map``.
  * They are forward only (every caller of the JAX functions is): they run
    under ``torch.no_grad()`` and raise on a tensor argument that requires
    grad.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from exoground_tpu_torch.models.aligner import _l2norm
from exoground_tpu_torch.ops.pos_embed import slice_or_interpolate_pos_embed
from exoground_tpu_torch.parallel import collectives
from exoground_tpu_torch.parallel.mesh import make_mesh
from exoground_tpu_torch.utils.shapes import round_up

NEG_INF = -1e30


def _forward_only(name: str, **tensors) -> None:
    grad = sorted(k for k, t in tensors.items() if t is not None and t.requires_grad)
    if grad:
        raise ValueError(f"{name} is forward only: {grad} require grad")


def _fold_block(q, kb, vb, mb, stats):
    """Fold one K/V block (``mb`` True at padded keys) into the running
    (max, sum, accumulator)."""
    m_run, l_run, acc = stats
    s = torch.matmul(q, kb.transpose(-1, -2)).masked_fill(mb[:, None, None, :], NEG_INF)
    m_new = torch.maximum(m_run, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_run - m_new)
    l_new = l_run * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.matmul(p, vb)
    return m_new, l_new, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor] = None, mesh=None,
                   scale: Optional[float] = None, extra_k: Optional[torch.Tensor] = None,
                   extra_v: Optional[torch.Tensor] = None,
                   extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact softmax(q·kᵀ·scale)·v of this rank's queries over every rank's
    keys, the K/V blocks passed round the ring of ``mesh`` (the process
    group's by default).

    q (B, H, Sq, D), k / v (B, H, Sk, D) and ``key_padding_mask`` (B, Sk,
    True at PAD) are this rank's blocks, the same Sk on every rank. The
    optional ``extra_k`` / ``extra_v`` (B, H, Ke, D) block, the same on every
    rank, folds in once after the ring (``extra_mask`` (B, Ke)). Returns
    this rank's (B, H, Sq, D) output."""
    _forward_only("ring_attention", q=q, k=k, v=v, extra_k=extra_k, extra_v=extra_v)
    mesh = make_mesh() if mesh is None else mesh
    with torch.no_grad():
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        q = q * scale
        if key_padding_mask is None:
            key_padding_mask = torch.zeros(k.shape[0], k.shape[2], dtype=torch.bool,
                                           device=k.device)
        b, h, sq, d = q.shape
        stats = (torch.full((b, h, sq), NEG_INF, dtype=q.dtype, device=q.device),
                 torch.zeros((b, h, sq), dtype=q.dtype, device=q.device),
                 torch.zeros((b, h, sq, d), dtype=q.dtype, device=q.device))
        # the mask travels as bytes: gloo sends no bool tensor
        block = [k.contiguous(), v.contiguous(), key_padding_mask.to(torch.uint8).contiguous()]
        for _ in range(mesh.world):
            finish = collectives.ring_shift(block, mesh)
            stats = _fold_block(q, block[0], block[1], block[2].bool(), stats)
            block = finish()
        if extra_k is not None:
            em = (torch.zeros(extra_k.shape[0], extra_k.shape[2], dtype=torch.bool,
                              device=extra_k.device) if extra_mask is None else extra_mask)
            stats = _fold_block(q, extra_k, extra_v, em, stats)
        _, l_fin, acc = stats
        return acc / torch.clamp(l_fin, min=1e-30)[..., None]


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = t.shape
    return t.reshape(b, s, heads, c // heads).transpose(1, 2)


def _encoder_layer_ring(block, x, mesh, key_padding_mask, n_ring=None, extra_mask=None,
                        mlp_impl=None):
    """One pre-LN encoder layer of ``block`` (an ``ops/blocks.py::
    ResidualAttentionBlock``: ``ln_1``, ``attn``'s projections, ``ln_2``,
    ``mlp``) with its self-attention on the ring. With ``n_ring`` the rows
    are [ring part ⊕ replicated tail]: the first ``n_ring`` rows' K/V ride
    the ring, the tail's (``extra_mask`` its mask) fold in once; every row
    is a query."""
    c = x.shape[-1]
    heads = block.attn.num_heads
    attn = block.attn
    qkv = F.linear(block.ln_1(x), attn.in_proj_weight, attn.in_proj_bias)
    q, k, v = (_heads_first(t, heads) for t in qkv.split(c, dim=-1))
    if n_ring is None:
        o = ring_attention(q, k, v, key_padding_mask, mesh)
    else:
        o = ring_attention(q, k[:, :, :n_ring], v[:, :, :n_ring],
                           key_padding_mask[:, :n_ring], mesh, extra_k=k[:, :, n_ring:],
                           extra_v=v[:, :, n_ring:], extra_mask=extra_mask)
    b, _, s, _ = o.shape
    x = x + attn.out_proj(o.transpose(1, 2).reshape(b, s, c))
    return x + block.mlp(block.ln_2(x), impl=mlp_impl)


def _gather_seq(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, in rank order."""
    if not mesh.grouped:
        return x
    moved = x.movedim(dim, 0).contiguous()
    return collectives.all_gather_rows(moved, mesh).movedim(0, dim)


def _check_layers(model, heads, n_enc, n_joint):
    """The layer counts within the model's towers, ``heads`` its heads."""
    towers = (model.video_temporal_encoder.resblocks, model.joint_temporal_encoder.resblocks)
    for name, n, blocks in (("encoder", n_enc, towers[0]), ("joint", n_joint, towers[1])):
        if n > len(blocks):
            raise ValueError(f"{n} {name} layers asked of a model with {len(blocks)}")
    have = {blk.attn.num_heads for blocks in towers for blk in blocks}
    if heads is not None and have - {heads}:
        raise ValueError(f"heads={heads}, but the model's attention has {sorted(have)} heads")


def sequence_parallel_sim(model, video: torch.Tensor, text_embed: torch.Tensor, mesh=None,
                          num_encoder_layers: Optional[int] = None, num_joint_layers: int = 0,
                          heads: Optional[int] = None, interpolate_from: Optional[int] = None,
                          video_padding_mask: Optional[torch.Tensor] = None,
                          text_padding_mask: Optional[torch.Tensor] = None,
                          use_text_pos_enc: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Global-mode similarity of ``model`` (a port ``TemporalAligner``) with
    the time axis split over the ranks of ``mesh``.

    video (B, S, Dv) is the whole video (any S) on every rank, text_embed
    (K, Dt) the query texts; ``video_padding_mask`` (B, S) and
    ``text_padding_mask`` (B, K) or (K,) are True at PAD. Runs the first
    ``num_encoder_layers`` dual layers (the model's count by default) and
    ``num_joint_layers`` joint layers (0 skips the joint tower);
    ``use_text_pos_enc`` defaults to the model's. Returns {'dual-sim': (B,
    S, K)[, 'sim': (B, S, K) joint]} on every rank: the last-stage outputs
    of ``TemporalAligner.text_visual_sim`` at O(S / world) activation memory
    a rank."""
    _forward_only("sequence_parallel_sim", video=video, text_embed=text_embed)
    n_enc = model.num_encoder_layers if num_encoder_layers is None else num_encoder_layers
    _check_layers(model, heads, n_enc, num_joint_layers)
    mesh = make_mesh() if mesh is None else mesh
    text_pos_on = bool(model.use_text_pos_enc) if use_text_pos_enc is None else use_text_pos_enc
    n, r = mesh.world, mesh.rank
    b, s, _ = video.shape
    k = text_embed.shape[0]
    dev = video.device
    s_pad = round_up(max(s, n), n)
    with torch.no_grad():
        vmask = (torch.zeros((b, s), dtype=torch.bool, device=dev)
                 if video_padding_mask is None else video_padding_mask)
        if s_pad != s:
            video = F.pad(video, (0, 0, 0, s_pad - s))
            vmask = F.pad(vmask, (0, s_pad - s), value=True)
        tmask = (torch.zeros((b, k), dtype=torch.bool, device=dev) if text_padding_mask is None
                 else text_padding_mask.expand(b, k))
        # the position embedding of the REAL length (interpolation resamples
        # to s, as the model path does), zero-padded: pad rows are key-masked
        pos = slice_or_interpolate_pos_embed(model.temporal_pos_embed, s, interpolate_from, 0)
        if s_pad != s:
            pos = F.pad(pos, (0, 0, 0, s_pad - s))
        sl = s_pad // n
        rows = slice(r * sl, (r + 1) * sl)
        video_blk, vmask_blk, pos_blk = video[:, rows], vmask[:, rows], pos[rows]

        # the text side, position-wise and the same on every rank
        t_raw = model.get_textual_feature(text_embed[None].expand(b, k, text_embed.shape[1]))
        xv = model.preproject_video(video_blk)
        xv = xv + model.ln_position_init(pos_blk.to(xv.dtype))[None]

        # dual tower: ring self-attention over the split time axis
        x = xv
        for blk in model.video_temporal_encoder.resblocks[:n_enc]:
            x = _encoder_layer_ring(blk, x, mesh, vmask_blk, mlp_impl=model.mlp_impl)
        x = _l2norm(model.ln_video_post_enc(x))
        out = {"dual-sim": torch.einsum("bsc,bkc->bsk", x, _l2norm(t_raw))}

        if num_joint_layers:
            # joint tower: [video block ⊕ text]; the text K/V fold in once
            t_j = t_raw
            if text_pos_on:
                text_pos = slice_or_interpolate_pos_embed(model.text_temporal_pos_embed, k,
                                                          None, 0)
                t_j = t_j + model.ln_position_init(text_pos.to(t_j.dtype))[None]
            xj = torch.cat([xv, t_j], dim=1)
            jmask = torch.cat([vmask_blk, tmask], dim=1)
            for blk in model.joint_temporal_encoder.resblocks[:num_joint_layers]:
                xj = _encoder_layer_ring(blk, xj, mesh, jmask, n_ring=sl, extra_mask=tmask,
                                         mlp_impl=model.mlp_impl)
            xj = model.ln_joint_post_enc(xj)
            out["sim"] = torch.einsum("bsc,bkc->bsk", _l2norm(xj[:, :sl]), _l2norm(xj[:, sl:]))
        return {key: _gather_seq(val, mesh, 1)[:, :s] for key, val in out.items()}


def sequence_parallel_dual_sim(model, video: torch.Tensor, text_embed: torch.Tensor,
                               mesh=None, num_layers: Optional[int] = None,
                               heads: Optional[int] = None,
                               interpolate_from: Optional[int] = None,
                               video_padding_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The dual tower's last-stage global similarity (B, S, K) alone
    (``sequence_parallel_sim`` without the joint tower)."""
    return sequence_parallel_sim(
        model, video, text_embed, mesh, num_encoder_layers=num_layers, num_joint_layers=0,
        heads=heads, interpolate_from=interpolate_from,
        video_padding_mask=video_padding_mask)["dual-sim"]


def sequence_sharded_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    mesh=None,
                                    key_padding_mask: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Self-attention of the global q / k / v (B, H, S, D) with S split over
    the ranks of ``mesh`` (S must divide by the world) and the K/V blocks
    on the ring; the global (B, H, S, D) output on every rank."""
    _forward_only("sequence_sharded_self_attention", q=q, k=k, v=v)
    mesh = make_mesh() if mesh is None else mesh
    s = q.shape[2]
    if s % mesh.world:
        raise ValueError(f"S {s} does not split over {mesh.world} ranks")
    sl = s // mesh.world
    rows = slice(mesh.rank * sl, (mesh.rank + 1) * sl)
    if key_padding_mask is None:
        key_padding_mask = torch.zeros(q.shape[0], s, dtype=torch.bool, device=q.device)
    out = ring_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows],
                         key_padding_mask[:, rows], mesh)
    return _gather_seq(out, mesh, 2)
