"""The one bridge between the two packages' weights: the JAX package's
flax parameter tree, as numpy arrays, onto the port's ``state_dict``.

Takes numpy and imports nothing of the JAX package.  The mapping:

* ``nn.scan``-stacked ``[L, ...]`` block leaves are unstacked into
  ``blocks.<i>``;
* ``Dense``/``DenseGeneral`` kernels (``[in..., out...]``) are flattened
  to 2-D and transposed into ``nn.Linear``'s ``[out, in]`` layout, their
  biases flattened;
* flax's auto-named norms (``RMSNorm_0``/``LayerNorm_0`` …) map to
  ``norm_0``/``norm_1``/``norm_2`` in a block; T5's top-level
  ``RMSNorm_0``/``RMSNorm_1`` are the encoder's and the decoder's final
  norms;
* a tied model has no head weight on either side: its head reads the
  token embedding, so the tie holds by construction;
* a Mixtral block's ``moe`` router kernel ``[d, E]`` is transposed like
  any dense kernel, its expert stacks ``[E, d, ff]`` / ``[E, ff, d]`` are
  the port's layout already;
* ViT's patch-embedding conv kernel ``[P, P, C, d]`` becomes ``Conv2d``'s
  ``[d, C, P, P]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .configs import EncDecConfig, TransformerConfig, VisionConfig

__all__ = ["from_flax_params"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _dense(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping,
           n_in_dims: int, i=None) -> None:
    kernel = np.asarray(leaf["kernel"])
    if i is not None:
        kernel = kernel[i]
    n_in = int(np.prod(kernel.shape[:n_in_dims]))
    sd[f"{name}.weight"] = _t(kernel.reshape(n_in, -1).T)
    if "bias" in leaf:
        bias = np.asarray(leaf["bias"])
        sd[f"{name}.bias"] = _t((bias[i] if i is not None else bias).reshape(-1))


def _norm(sd: Dict[str, torch.Tensor], name: str, leaf: Mapping, i=None):
    for k in ("scale", "bias"):
        if k in leaf:
            a = np.asarray(leaf[k])
            sd[f"{name}.{k}"] = _t(a[i] if i is not None else a)


def _norm_base(cfg: TransformerConfig) -> str:
    return "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"


def _block(sd: Dict[str, torch.Tensor], pre: str, blk: Mapping, i: int,
           cfg: TransformerConfig, n_norms: int, attns=("attn",)) -> None:
    """Layer ``i`` of an ``nn.scan``-stacked block tree onto ``pre``."""
    for n in range(n_norms):
        _norm(sd, f"{pre}.norm_{n}", blk[f"{_norm_base(cfg)}_{n}"], i)
    for mod in attns:
        for name in ("wq", "wk", "wv"):
            _dense(sd, f"{pre}.{mod}.{name}", blk[mod][name], 1, i)
        _dense(sd, f"{pre}.{mod}.wo", blk[mod]["wo"], 2, i)
    if "moe" in blk:
        moe = blk["moe"]
        _dense(sd, f"{pre}.moe.router", moe["router"], 1, i)
        for name in ("w_gate", "w_up", "w_down"):
            sd[f"{pre}.moe.{name}"] = _t(np.asarray(moe[name])[i])
        return
    for name, leaf in blk["mlp"].items():
        _dense(sd, f"{pre}.mlp.{name}", leaf, 1, i)


def _t5(cfg: EncDecConfig, p: Mapping) -> Dict[str, torch.Tensor]:
    sd = {"shared_embed.weight": _t(p["shared_embed"]["embedding"]),
          "enc_relpos.embedding": _t(p["enc_relpos"]["embedding"]),
          "dec_relpos.embedding": _t(p["dec_relpos"]["embedding"])}
    for i in range(cfg.encoder.n_layers):
        _block(sd, f"enc_blocks.{i}", p["enc_blocks"], i, cfg.encoder, 2)
    for i in range(cfg.decoder.n_layers):
        _block(sd, f"dec_blocks.{i}", p["dec_blocks"], i, cfg.decoder, 3,
               ("attn", "cross"))
    _norm(sd, "enc_norm", p[f"{_norm_base(cfg.encoder)}_0"])
    _norm(sd, "dec_norm", p[f"{_norm_base(cfg.decoder)}_1"])
    if not cfg.tie_embeddings:
        _dense(sd, "lm_head", p["lm_head"], 1)
    return sd


def _vit(cfg: VisionConfig, p: Mapping) -> Dict[str, torch.Tensor]:
    conv = p["patch_embed"]
    sd = {"patch_embed.weight": _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)),
          "patch_embed.bias": _t(conv["bias"]),
          "pos_embed": _t(p["pos_embed"])}
    if cfg.pool == "cls":
        sd["cls"] = _t(p["cls"])
    for i in range(cfg.encoder.n_layers):
        _block(sd, f"blocks.{i}", p["blocks"]["block"], i, cfg.encoder, 2)
    _norm(sd, "final_norm", p["final_norm"])
    _dense(sd, "head", p["head"], 1)
    return sd


def from_flax_params(family: str, cfg, params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``family`` (``"llama"`` — Mixtral
    included — | ``"gpt2"`` with a ``TransformerConfig``, ``"t5"`` with an
    ``EncDecConfig``, ``"vit"`` with a ``VisionConfig``) from the JAX
    model's parameters (``{"params": ...}`` or the inner tree), leaves as
    numpy arrays.  Load it with ``model.load_state_dict(sd)``, which casts
    to the model's dtypes."""
    p = params.get("params", params)
    if family == "t5":
        return _t5(cfg, p)
    if family == "vit":
        return _vit(cfg, p)
    if family not in ("llama", "gpt2"):
        raise ValueError(f"unknown family {family!r} (gpt2 | llama | t5 | vit)")
    sd: Dict[str, torch.Tensor] = {}
    if family == "llama":
        sd["embed.weight"] = _t(p["embed"]["embedding"])
    else:
        sd["wte.weight"] = _t(p["wte"]["embedding"])
        sd["wpe.weight"] = _t(p["wpe"]["embedding"])
    for i in range(cfg.n_layers):
        _block(sd, f"blocks.{i}", p["blocks"]["block"], i, cfg, 2)
    _norm(sd, "final_norm", p["final_norm"])
    if not cfg.tie_embeddings:
        _dense(sd, "lm_head", p["lm_head"], 1)
    return sd
