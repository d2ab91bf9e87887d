"""Weight bridge between the JAX package's param trees and the port's
state dicts, and the reference checkpoint loader.

``tan_state_dict_from_jax`` is the exact inverse of the JAX package's
``utils/convert.py::convert_tan_state_dict``, ``grounding_state_dict_from_jax``
of ``convert_exoground_state_dict`` (an ``ExoGroundingTransformer``) and
``convert_grounding_state_dict`` (a ``GroundingModel``: its trunk at the top
level, as the reference inlines it, and ``vi_encoder.*``, MLP or
transformer):

  Dense kernel (in, out)           -> Linear weight (out, in)  [transpose]
  in_proj_kernel (C, 3C)           -> in_proj_weight (3C, C)   [transpose]
  LayerNorm scale / bias           -> weight / bias
  pos tables                       -> as they are

``tan_checkpoint_from_jax`` (``grounding_checkpoint_from_jax`` for the
grounding family) bridges a whole JAX checkpoint (as
``train/checkpoint.py::load_state`` reads the JAX package's msgpack file)
to the port's checkpoint layout: parameters, the EMA twin and Adam's moments
through ``tan_state_dict_from_jax`` (the bridge is linear, transposes only,
so moments map as their parameters do), the count, and the accumulator and
mini step of a ``MultiStepsState``.

The port's module names are the reference's torch state-dict names, so a
reference checkpoint needs no mapping at all (``load_reference_state``).
``load_torch_checkpoint`` and ``convert_word2vec_from_s3d`` read the MIL-NCE
S3D checkpoint's text tower (the JAX package's functions of the same names,
in the tower's torch layout).

The S3D finetune (``models/s3d.py``) takes the MIL-NCE checkpoint as it is
(``convert_s3d_state_dict``: its names are the port's, the BN running stats
split off into ``batch_stats``; ``convert_sentence_embedding_from_s3d``: the
text module). ``s3d_state_dict_from_jax`` maps the JAX S3D's variables to
the port's tensors:

  Conv kernel (kT, kH, kW, I, O)   -> Conv3d weight (O, I, kT, kH, kW)
  Dense kernel (in, out)           -> Linear weight (out, in)
  BatchNorm scale / bias           -> weight / bias
  batch_stats mean / var           -> running_mean / running_var

and ``s3d_checkpoint_from_jax`` a JAX ``S3DTrainer`` checkpoint (parameters
``s3d.*`` and ``text.*``, their Adam moments, ``batch_stats``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from exoground_tpu_torch.models.grounding import GroundingModel
from exoground_tpu_torch.models.s3d import BatchNorm as S3DBatchNorm
from exoground_tpu_torch.models.vi_encoder import ViewInvariantMLP
from exoground_tpu_torch.models.word2vec import TOWER_KEYS
from exoground_tpu_torch.ops.attention import MultiHeadAttention

# in the reference's state dict and the port's model, but in no JAX tree:
# the reference's TemporalAligner and ExoGroundingTransformer hold an ``mlp``
# Linear their forwards never use
UNUSED_REFERENCE_KEYS = ("mlp.weight", "mlp.bias")


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor of ``a``: a numpy or JAX array, or a tensor (the
    msgpack reader's bfloat16 arrays)."""
    if torch.is_tensor(a):
        return a.float().contiguous()
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _tt(a) -> torch.Tensor:
    """``_t`` of a transposed 2-d array."""
    return _t(a).T.contiguous()


# The converters' renames, leaf by leaf, by the kind of module that holds
# the leaf: JAX leaf -> the port's name under that module (``jax_name``
# inverts them). A JAX embedding table is a leaf of its parent, the port's
# the ``weight`` of an ``nn.Embedding``.
_DENSE_LEAF = {"kernel": "weight", "bias": "bias"}  # Dense and Conv; kernels transposed
_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_ATTN_LEAF = {"in_proj_kernel": "in_proj_weight", "in_proj_bias": "in_proj_bias",
              "out_proj_kernel": "out_proj.weight", "out_proj_bias": "out_proj.bias"}
_EMBED_LEAF = {"": "weight"}
# module names that differ: a ViewInvariantMLP's nn.Sequential indices, and
# a GroundingModel's trunk, which the port inlines at its top level
_VI_MLP = {"mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}
_TRUNK = "trunk"
NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase, S3DBatchNorm)


def _dense(out, key, p, bias=True):
    out[f"{key}.{_DENSE_LEAF['kernel']}"] = _tt(p["kernel"])
    if bias and "bias" in p:
        out[f"{key}.{_DENSE_LEAF['bias']}"] = _t(p["bias"])


def _ln(out, key, p):
    for leaf in ("scale", "bias"):
        out[f"{key}.{_NORM_LEAF[leaf]}"] = _t(p[leaf])


def _attn(out, key, p):
    for leaf, name in _ATTN_LEAF.items():
        out[f"{key}.{name}"] = (_tt if leaf.endswith("kernel") else _t)(p[leaf])


def _leaf_renames(m: nn.Module) -> Mapping:
    """The leaf renames of the kind of module ``m`` is."""
    if isinstance(m, nn.Embedding):
        return _EMBED_LEAF
    if isinstance(m, MultiHeadAttention):
        return _ATTN_LEAF
    return _NORM_LEAF if isinstance(m, NORMS) else _DENSE_LEAF


def jax_name(name: str, module: nn.Module) -> str:
    """The JAX name ('/'-joined) that the converters of this module map to
    the port tensor ``name`` of ``module`` (a parameter, a buffer, or an S3D
    running stat): the leaf through the renames of its module's kind (a
    leaf they do not rename keeps its name; an attention's ``out_proj.*``
    are leaves of the attention), ``resblocks.i`` as ``resblocks_i``, a
    ViewInvariantMLP's ``mlp.0`` / ``mlp.2`` as ``mlp_fc1`` / ``mlp_fc2``,
    a GroundingModel's tensors outside ``vi_encoder`` under ``trunk``."""
    owner, _, leaf = name.rpartition(".")
    parent, _, last = owner.rpartition(".")
    if last == "out_proj" and isinstance(module.get_submodule(parent), MultiHeadAttention):
        owner, leaf = parent, f"out_proj.{leaf}"
    jax_leaf = {port: j for j, port in _leaf_renames(module.get_submodule(owner)).items()}
    leaf = jax_leaf.get(leaf, leaf)
    for j, port in _VI_MLP.items():
        head = owner[:-len(port)].rstrip(".")
        if (owner == port or owner.endswith(f".{port}")) and isinstance(
                module.get_submodule(head), ViewInvariantMLP):
            owner = f"{head}.{j}" if head else j
    owner = re.sub(r"(^|\.)resblocks\.(\d+)(?=\.|$)", r"\1resblocks_\2", owner)
    if isinstance(module, GroundingModel) and not name.startswith("vi_encoder."):
        owner = f"{_TRUNK}.{owner}"
    return "/".join(p for p in owner.split(".") + [leaf] if p)


def encoder_state_dict_from_jax(stack: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One TemporalEncoder's or TemporalDecoder's JAX params ({"resblocks_0":
    ..., ...}; a decoder block adds ``self_attn`` and ``ln_3``) -> the port's
    state dict, keys prefixed with ``prefix`` (e.g.
    "video_temporal_encoder.")."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"resblocks_{i}" in stack:
        blk, pre = stack[f"resblocks_{i}"], f"{prefix}resblocks.{i}"
        for attn in ("self_attn", "attn"):
            if attn in blk:
                _attn(out, f"{pre}.{attn}", blk[attn])
        for ln in ("ln_1", "ln_2", "ln_3"):
            if ln in blk:
                _ln(out, f"{pre}.{ln}", blk[ln])
        _dense(out, f"{pre}.mlp.c_fc", blk["mlp"]["c_fc"])
        _dense(out, f"{pre}.mlp.c_proj", blk["mlp"]["c_proj"])
        i += 1
    return out


def tan_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """TemporalAligner JAX params (``{"params": ...}`` or the bare tree, numpy
    or JAX arrays) -> the port's state dict of float32 CPU tensors."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for stack in ("video_temporal_encoder", "joint_temporal_encoder"):
        out.update(encoder_state_dict_from_jax(p[stack], f"{stack}."))
    for dense in ("video_pre_proj", "text_pre_proj"):
        _dense(out, dense, p[dense], bias=False)
    for ln in ("ln_text_init", "ln_video_init", "ln_position_init",
               "ln_video_post_enc", "ln_joint_post_enc"):
        _ln(out, ln, p[ln])
    for table in ("temporal_pos_embed", "text_temporal_pos_embed"):
        if table in p:  # a sine table is a buffer, absent from the JAX tree
            out[table] = _t(p[table])
    if "binary_head" in p:
        _dense(out, "binary_head", p["binary_head"])
    return out


def find_adam(node):
    """The first map holding count, mu and nu in an optimizer state tree:
    ``FusedAdamWState`` itself, or the optax chain's ``ScaleByAdamState``
    wherever it nests (the JAX ``adapt_optimizer_state``'s ``find_adam``,
    train/optim.py:295-303)."""
    if isinstance(node, Mapping):
        if {"count", "mu", "nu"} <= set(node):
            return node
        for v in node.values():
            hit = find_adam(v)
            if hit is not None:
                return hit
    return None


def checkpoint_from_jax(blob: Mapping, bridge) -> Dict:
    """A JAX checkpoint's tree (``epoch``, ``state_dict``, ``best_acc``,
    ``optimizer``, ``iteration`` [, ``target_state_dict``]: the JAX
    trainer's ``_ckpt_state``, trainer.py:110-125) -> the port's checkpoint
    layout (``train/optim.py::optimizer_state_dict``): the trees through
    ``bridge`` (a params tree -> a state dict), the optimizer's Adam count /
    mu / nu from either JAX layout, and ``mini_step`` / ``acc_grads`` of a
    ``MultiStepsState``; epoch, iteration and best carried as they are."""
    out = {k: blob[k] for k in ("epoch", "iteration", "best_acc") if k in blob}
    out["state_dict"] = bridge(blob["state_dict"])
    if "target_state_dict" in blob:
        out["target_state_dict"] = bridge(blob["target_state_dict"])
    opt = blob.get("optimizer")
    adam = find_adam(opt)
    if adam is not None:
        out["optimizer"] = {"count": int(adam["count"]), "mu": bridge(adam["mu"]),
                            "nu": bridge(adam["nu"])}
        if {"mini_step", "acc_grads"} <= set(opt):
            out["optimizer"].update(mini_step=int(opt["mini_step"]),
                                    acc_grads=bridge(opt["acc_grads"]))
    return out


def tan_checkpoint_from_jax(blob: Mapping) -> Dict:
    """A JAX TAN checkpoint in the port's layout (``checkpoint_from_jax``)."""
    return checkpoint_from_jax(blob, tan_state_dict_from_jax)


def grounding_checkpoint_from_jax(blob: Mapping) -> Dict:
    """A JAX view-invariant, grounding or joint checkpoint in the port's
    layout (``checkpoint_from_jax`` through ``grounding_state_dict_from_jax``)."""
    return checkpoint_from_jax(blob, grounding_state_dict_from_jax)


def _grounding_trunk(p: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for stack in ("multi_modal_encoder", "video_unimodal_encoder", "text_unimodal_encoder",
                  "decoder"):
        if stack in p:
            out.update(encoder_state_dict_from_jax(p[stack], f"{stack}."))
    for dense in ("video_pre_proj", "text_pre_proj", "audio_pre_proj"):
        if dense in p:
            _dense(out, dense, p[dense], bias=False)
    for dense in ("grounding_head", "exo_feature_proj"):
        if dense in p:
            _dense(out, dense, p[dense])
    for ln in ("ln_text_init", "ln_video_init", "ln_position_init", "ln_joint_post_enc",
               "ln_video_post_enc", "ln_text_post_enc", "ln_audio_init"):
        if ln in p:
            _ln(out, ln, p[ln])
    for table in ("temporal_pos_embed", "text_temporal_pos_embed"):
        if table in p:  # a sine table is a buffer, absent from the JAX tree
            out[table] = _t(p[table])
    return out


def _vi_encoder(p: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _dense(out, "video_pre_proj", p["video_pre_proj"], bias=False)
    _ln(out, "ln_video_init", p["ln_video_init"])
    if "mlp_fc1" in p:  # ViewInvariantMLP: the reference's nn.Sequential indices
        for leaf, name in _VI_MLP.items():
            _dense(out, name, p[leaf])
        return out
    out.update(encoder_state_dict_from_jax(p["video_unimodal_encoder"],
                                           "video_unimodal_encoder."))
    for ln in ("ln_position_init", "ln_video_post_enc"):
        _ln(out, ln, p[ln])
    if "exo_feature_proj" in p:
        _dense(out, "exo_feature_proj", p["exo_feature_proj"])
    if "temporal_pos_embed" in p:
        out["temporal_pos_embed"] = _t(p["temporal_pos_embed"])
    return out


def grounding_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """ExoGroundingTransformer, GroundingModel or ViewInvariantMLP JAX params
    (``{"params": ...}`` or the bare tree; a GroundingModel's holds ``trunk``
    and ``vi_encoder``) -> the port's state dict of float32 CPU tensors."""
    p = params.get("params", params)
    if "mlp_fc1" in p:  # the view_invariant model itself
        return _vi_encoder(p)
    if _TRUNK not in p:
        return _grounding_trunk(p)
    out = _grounding_trunk(p[_TRUNK])
    if "vi_encoder" in p:
        out.update({f"vi_encoder.{k}": v for k, v in _vi_encoder(p["vi_encoder"]).items()})
    return out


def load_checked(model: torch.nn.Module, state: Mapping) -> None:
    """Load ``state`` (a converted JAX tree, or a port checkpoint's
    ``state_dict``); every key of the model must be filled, apart from the
    reference's unused ``mlp`` and the buffers the model computes itself (a
    sine pos table); a missing or unexpected key raises ``KeyError``, then a
    shape the model does not have ``RuntimeError`` (``load_state_dict``),
    naming them."""
    own = set(model.state_dict())
    allowed = set(UNUSED_REFERENCE_KEYS) | {name for name, _ in model.named_buffers()}
    bad, unexpected = sorted(own - set(state) - allowed), sorted(set(state) - own)
    if bad or unexpected:
        raise KeyError(f"the state does not fit the model: missing {bad}, "
                       f"unexpected {unexpected}")
    model.load_state_dict(state, strict=False)


def load_tan_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load JAX params into a port TemporalAligner (``load_checked``)."""
    load_checked(model, tan_state_dict_from_jax(params))


def load_grounding_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load JAX params into a port ExoGroundingTransformer or GroundingModel
    (``load_checked``)."""
    load_checked(model, grounding_state_dict_from_jax(params))


def strip_prefix(state: Mapping, prefix: str) -> Dict:
    """Keep only keys under ``prefix`` and strip it ('module.', 'target.', ...);
    a state without such keys is returned whole."""
    out = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return out if out else dict(state)


def load_reference_state(path: str) -> Dict:
    """The reference's released ``.pth.tar`` (reference utils/utils.py +
    main.py:532-537) as a state dict for the port's model (TemporalAligner,
    ExoGroundingTransformer, GroundingModel): DDP
    ``module.`` stripped and, for a cotrain checkpoint, the EMA twin's
    ``target.`` branch kept (the JAX package serves the same branch)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    state = strip_prefix(strip_prefix(state, "module."), "target.")
    return {k: v for k, v in state.items() if torch.is_tensor(v)}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth(.tar)`` file as {key: CPU tensor} (its ``state_dict``
    when it holds one), as the JAX package's ``load_torch_checkpoint`` reads
    it into numpy."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach() for k, v in state.items() if torch.is_tensor(v)}


def convert_word2vec_from_s3d(state: Mapping) -> Dict[str, torch.Tensor]:
    """MIL-NCE S3D checkpoint -> the frozen word2vec tower's tensors
    (reference model/word2vec_model.py:76-102 pulls text_module.{word_embd,
    fc1, fc2}); keys as ``models/word2vec.py::TOWER_KEYS``, float32."""
    prefix = "text_module." if any(k.startswith("text_module.") for k in state) else ""
    return {k: torch.as_tensor(np.asarray(state[prefix + k], np.float32)) for k in TOWER_KEYS}


# JAX leaf names -> the port's (a kernel is transposed as its rank says)
_JAX_LEAF = {**_NORM_LEAF, "word_embd": f"word_embd.{_EMBED_LEAF['']}"}


def _tree_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested JAX tree of the S3D family as named float32 tensors: conv
    kernels (kT, kH, kW, I, O) -> (O, I, kT, kH, kW), Dense kernels
    transposed, the other leaves renamed by ``_JAX_LEAF``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_tree_from_jax(v, f"{prefix}{k}."))
        elif k == "kernel":
            a = _t(v)
            out[prefix + _DENSE_LEAF[k]] = (a.permute(4, 3, 0, 1, 2) if a.dim() == 5
                                            else a.T).contiguous()
        else:
            out[prefix + _JAX_LEAF[k]] = _t(v)
    return out


def s3d_state_dict_from_jax(variables: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX S3D's ``{'params', 'batch_stats'}`` (numpy or JAX arrays) ->
    ``{'params', 'batch_stats'}`` of the port's ``S3D`` (float32 CPU
    tensors by the reference's names)."""
    return {"params": _tree_from_jax(variables["params"]),
            "batch_stats": _tree_from_jax(variables.get("batch_stats", {}))}


def s3d_checkpoint_from_jax(blob: Mapping) -> Dict:
    """A JAX ``S3DTrainer`` checkpoint (``{'s3d', 'text'}`` parameters, Adam
    moments, ``batch_stats``) in the port's layout (``checkpoint_from_jax``):
    parameters ``s3d.<name>`` and ``text.<tower key>``, the stats by the
    S3D's names."""
    out = checkpoint_from_jax(blob, _tree_from_jax)
    if "batch_stats" in blob:
        out["batch_stats"] = _tree_from_jax(blob["batch_stats"])
    return out


def convert_s3d_state_dict(state: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The MIL-NCE S3D checkpoint (reference s3dg.py:250-310 names; DDP
    ``module.`` stripped) -> ``{'params', 'batch_stats'}`` of the port's
    ``S3D`` as float32 tensors: the names are the same, the BN running stats
    go to ``batch_stats`` (``num_batches_tracked`` dropped) and the text
    module is left out (``convert_sentence_embedding_from_s3d``)."""
    state = strip_prefix(state, "module.")
    trunk = {k: _t(v) for k, v in state.items()
             if not k.startswith("text_module.") and not k.endswith(".num_batches_tracked")}
    stat = (".running_mean", ".running_var")
    return {"params": {k: v for k, v in trunk.items() if not k.endswith(stat)},
            "batch_stats": {k: v for k, v in trunk.items() if k.endswith(stat)}}


def convert_sentence_embedding_from_s3d(state: Mapping) -> Dict[str, torch.Tensor]:
    """The S3D checkpoint's Sentence_Embedding (s3dg.py:186-239), DDP prefix
    stripped: the word2vec tower's tensors (``convert_word2vec_from_s3d``),
    the reference's two text modules sharing one layout."""
    return convert_word2vec_from_s3d(strip_prefix(state, "module."))
