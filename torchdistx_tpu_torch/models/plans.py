"""Stock sharding plans for the model families (counterpart of
``torchdistx_tpu/models/plans.py``).

Megatron-style 2D (fsdp × tp) layouts over the port's parameter names
(``blocks.<i>.attn.wq.weight`` ...), in ``nn.Linear``'s ``[out, in]``
layout with the attention heads flattened into one dim.  Each rule is
the reference's rule over its flax layout, translated: the leading layer
dim of the scan-stacked tree is gone, ``[in, out]`` kernels are
transposed, and ``[H, hd]`` head dims are one ``H·hd`` dim.

The reference shards a head dim only when ``tp`` divides the head count
``H`` (``KV`` for wk/wv).  A flattened ``H·hd`` dim may be divisible
where ``H`` is not, and sharding it would split heads, so these plans
take the head counts from the model's config and replicate such a dim
(with the reference's warning) whatever ``H·hd`` allows.

All rules degrade gracefully: indivisible dims fall back to replication
with a warning (parallel/sharding.py).
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

from ..parallel.sharding import (
    PartitionSpec as P,
    ShardingPlan,
    _axis_size,
    _drop_absent_axes,
    _validate_spec,
    mesh_shape,
)

# (name pattern, dim of the flattened heads, "q" (H) or "kv" (KV heads))
HeadRule = Tuple[str, int, str]


class HeadShardingPlan(ShardingPlan):
    """First-match rules, plus the head-count divisibility rule for dims
    that hold flattened heads: ``heads(name)`` gives ``(H, KV)`` of the
    stack ``name`` belongs to."""

    def __init__(self, rules, head_rules: Sequence[HeadRule],
                 heads: Callable[[str], Tuple[int, int]]):
        super().__init__(rules)
        self.head_rules = [(re.compile(p), d, k) for p, d, k in head_rules]
        self.heads = heads

    def spec_for(self, name, shape, mesh=None):
        spec = super().spec_for(name, shape)
        if mesh is None:
            return spec
        shape_map = mesh_shape(mesh)
        for pat, dim, kind in self.head_rules:
            if not pat.fullmatch(name) or dim >= len(spec):
                continue
            axis = _drop_absent_axes(spec[dim], shape_map)
            size = _axis_size(shape_map, axis)
            n = self.heads(name)[0 if kind == "q" else 1]
            if size > 1 and n % size:
                warnings.warn(
                    f"ShardingPlan: `{name}` dim {dim} holds {n} heads, not "
                    f"divisible by mesh axis {axis!r} (size {size}); "
                    f"replicating that dim instead."
                )
                spec = P(*(None if i == dim else a for i, a in enumerate(spec)))
            break
        return _validate_spec(name, shape, spec, shape_map)


def _block_rules(fsdp: Optional[str], tp: Optional[str], attns: str):
    """Megatron-style rules for the shared block layouts (attention +
    dense MLP), and the head rules of their attention dims."""
    rules = [
        # attention projections [H·hd, d] / [d, H·hd]
        (rf".*({attns})\.w[qkv]\.weight", P(tp, fsdp)),
        (rf".*({attns})\.wo\.weight", P(fsdp, tp)),
        (rf".*({attns})\.w[qkv]\.bias", P(tp)),
        (rf".*({attns})\.wo\.bias", P()),
        # dense MLP [ff, d] / [d, ff]
        (r".*mlp\.w_(gate|up)\.weight", P(tp, fsdp)),
        (r".*mlp\.w_down\.weight", P(fsdp, tp)),
        (r".*mlp\.w_(gate|up)\.bias", P(tp)),
        (r".*mlp\.w_down\.bias", P()),
    ]
    head_rules: List[HeadRule] = [
        (rf".*({attns})\.wq\.(weight|bias)", 0, "q"),
        (rf".*({attns})\.w[kv]\.(weight|bias)", 0, "kv"),
        (rf".*({attns})\.wo\.weight", 1, "q"),
    ]
    return rules, head_rules


def decoder_lm_plan(cfg, *, fsdp: Optional[str] = "fsdp",
                    tp: Optional[str] = "tp",
                    ep: Optional[str] = "ep") -> ShardingPlan:
    """Plan for the port's Llama / GPT-2 / Mixtral modules of ``cfg`` (a
    ``TransformerConfig``: its head counts decide the attention dims).

    Pass ``tp=None`` (etc.) to drop an axis entirely when building a plan
    for a mesh that intentionally lacks it — no absent-axis warnings."""
    rules, head_rules = _block_rules(fsdp, tp, "attn")
    rules += [
        # MoE experts [E, d, ff] / [E, ff, d] (the JAX layout), the router
        # [E, d] (the JAX [d, E] kernel's P(fsdp, None), transposed)
        (r".*moe\.w_(gate|up)", P(ep, fsdp, tp)),
        (r".*moe\.w_down", P(ep, tp, fsdp)),
        (r".*moe\.router\.weight", P(None, fsdp)),
        # embeddings / head
        (r".*(embed|wte)\.weight", P(tp, fsdp)),
        (r".*wpe\.weight", P(None, fsdp)),
        (r".*lm_head\.weight", P(tp, fsdp)),
        # norms and everything else: replicated (default)
    ]
    heads = (cfg.n_heads, cfg.kv_heads)
    return HeadShardingPlan(rules, head_rules, lambda name: heads)


def vit_plan(cfg, *, fsdp: Optional[str] = "fsdp",
             tp: Optional[str] = "tp") -> ShardingPlan:
    """2D plan for the port's ViT module of ``cfg`` (a ``VisionConfig``):
    the shared block rules and the vision stem — the conv weight
    ``[d, C, P, P]`` over tp on its output channels (the RGB dim is 3,
    never divisible), positions over fsdp, the head ``[n_classes, d]`` as
    the JAX ``[d, n_classes]`` kernel's ``P(fsdp, tp)``, transposed."""
    rules, head_rules = _block_rules(fsdp, tp, "attn")
    rules += [
        (r".*patch_embed\.weight", P(tp)),
        (r".*pos_embed", P(None, None, fsdp)),
        (r".*head\.weight", P(tp, fsdp)),
    ]
    heads = (cfg.encoder.n_heads, cfg.encoder.kv_heads)
    return HeadShardingPlan(rules, head_rules, lambda name: heads)


def t5_plan(cfg, *, fsdp: Optional[str] = "fsdp",
            tp: Optional[str] = "tp") -> ShardingPlan:
    """2D plan for the port's T5 module of ``cfg`` (an ``EncDecConfig``;
    ``enc_*`` names take the encoder's head counts, the rest the
    decoder's)."""
    rules, head_rules = _block_rules(fsdp, tp, "attn|cross")
    rules += [
        (r".*shared_embed\.weight", P(tp, fsdp)),
        (r".*relpos\.embedding", P(None, tp)),
        (r".*lm_head\.weight", P(tp, fsdp)),
    ]
    enc, dec = cfg.encoder, cfg.decoder

    def heads(name: str) -> Tuple[int, int]:
        c = enc if name.startswith("enc_") else dec
        return c.n_heads, c.kv_heads

    return HeadShardingPlan(rules, head_rules, heads)
