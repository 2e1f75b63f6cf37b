"""Transformer building blocks as ``nn.Module``s (counterpart of
``torchdistx_tpu/models/layers.py``).

The numerical conventions are the JAX package's, so the two agree on
identical weights:

* matmuls run in ``cfg.dtype`` on weights stored in ``cfg.param_dtype``
  (flax's ``dtype``/``param_dtype`` pair): inputs, weight and bias are
  cast to the compute dtype before the product;
* norms compute in float32 and cast back to the input dtype; their
  parameters are float32 whatever ``param_dtype`` says, as in flax;
* attention softmaxes in float32 with ``-1e30`` masking, the causal mask
  is ``tril(k=T-S)`` (the last query aligned with the last key);
* RoPE rotates split **halves** of the head dim, not interleaved pairs;
* GELU is the tanh approximation;
* the mixture of experts routes as the JAX ``MoEMLP`` does (capacity
  from the token count, token-major slots, one-hot dispatch and combine
  einsums), so the same tokens are dropped.

Initial values follow the distributions of the flax initializers the
JAX modules use (LeCun truncated normal for dense kernels, zeros for
biases, normal with std ``1/sqrt(features)`` for embeddings, ones for
norm scales), not their bits.  Every module takes ``device`` so a model
can be recorded under :func:`..deferred_init.deferred_init` claiming the
device it will be materialized on.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.segments import normalize_segment_ids
from .configs import TransformerConfig

# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# lecun_normal divides by it so the truncated draw has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float) -> torch.Tensor:
    """Fill ``w`` from a normal of ``std`` truncated to ``[-2 std, 2 std]``
    by inverse-CDF sampling, as ``jax.random.truncated_normal`` draws.

    Unlike ``torch.nn.init.trunc_normal_`` (which rejection-samples in
    recent torch), nothing here reads a value, so a deferred-init
    recording never has to replay it early."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        w.uniform_(lo, hi)
        w.erfinv_()
        w.mul_(std * math.sqrt(2.0))
        return w.clamp_(min=-2 * std, max=2 * std)


def default_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,  # [H or 1, S, T]
    segment_ids=None,  # [B, S] or ([B, S], [B, T]): packed sequences
) -> torch.Tensor:
    """Plain attention with GQA head-group broadcasting, f32 softmax.

    ``segment_ids`` masks cross-segment pairs: query i attends key j only
    when their segment ids are equal ([B, S] for self-attention, a
    ``(q_seg, kv_seg)`` pair for cross-attention)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    KV = k.shape[2]
    groups = H // KV
    qf = q.float() * (1.0 / math.sqrt(D))
    kf = k.float()
    vf = v.float()
    qf = qf.reshape(B, S, KV, groups, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, kf)
    if bias is not None:
        if bias.shape[0] == 1:
            logits = logits + bias[None, :, None]
        else:
            logits = logits + bias.reshape(1, KV, groups, *bias.shape[-2:])
    mask = None
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        mask = mask[None, None, None]
    if segment_ids is not None:
        q_seg, kv_seg = normalize_segment_ids(segment_ids, B, S, T)
        seg = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(B, S, H, D).to(q.dtype)


# The attention signature every model layer calls (the JAX package's
# ``AttnFn``): q [B, S, H, D], k / v [B, T, KV, D], keyword ``causal`` and
# optional ``bias`` / ``segment_ids`` -> [B, S, H, D].
AttnFn = Callable[..., torch.Tensor]


class Linear(nn.Linear):
    """``nn.Linear`` (weight ``[out, in]``) stored in ``param_dtype`` and
    computed in ``dtype``, initialized like flax's ``Dense``/
    ``DenseGeneral``: LeCun truncated normal over ``in_features``, zero
    bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        trunc_normal_(self.weight, std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    """``nn.Embedding`` stored in ``param_dtype``, looked up in ``dtype``,
    initialized like flax's ``nn.Embed`` (normal, std 1/sqrt(features))."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__(num_embeddings, features, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, std=self.embedding_dim ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)

    def attend(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
        """``x @ embedding.T`` in ``dtype``, the compute dtype by default
        (flax ``Embed.attend``).

        Under tensor parallelism the weight is a DTensor with the vocab
        over ``tp``: ``x`` enters replicated and the logits leave
        gathered, as a column-parallel head gives them."""
        dt = dtype or self.compute_dtype
        w = self.weight.to(dt)
        if type(w) not in (torch.Tensor, nn.Parameter):
            # Imported here: torch.distributed.tensor pulls in ~500 modules.
            from torch.distributed.tensor import DTensor, Replicate

            if isinstance(w, DTensor):
                mesh = w.device_mesh
                x = DTensor.from_local(x.to(dt), mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
                return (x @ w.T).full_tensor()
        return x.to(dt) @ w.T


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(dtype)


def make_norm(cfg: TransformerConfig, device=None) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
    return LayerNorm(cfg.d_model, cfg.norm_eps, device=device)


def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     device=None) -> torch.Tensor:
    """[max_len, head_dim//2] rotation angles, f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; angles: [S, D/2], or [B, S, D/2] for per-sequence
    positions (serving decode rotates each lane at its own position)."""
    dtype = x.dtype
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if angles.dim() == 3:
        cos = angles.cos()[:, :, None, :]
        sin = angles.sin()[:, :, None, :]
    else:
        cos = angles.cos()[None, :, None, :]
        sin = angles.sin()[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


def _dense(cfg: TransformerConfig, n_in: int, n_out: int, device,
           bias: Optional[bool] = None) -> Linear:
    return Linear(n_in, n_out, cfg.use_bias if bias is None else bias,
                  dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)


def _optional_attn_kwargs(bias, segment_ids) -> dict:
    """Optional operands only when present, so bias- and segment-less
    AttnFns stay valid."""
    kwargs = {}
    if bias is not None:
        kwargs["bias"] = bias
    if segment_ids is not None:
        kwargs["segment_ids"] = segment_ids
    return kwargs


class Attention(nn.Module):
    """Self-attention; ``attn_fn`` computes the attention itself (plain
    :func:`default_attention` unless a model is built with, e.g., the
    flash kernels' ``make_flash_attention()``).  Serving's prefill and
    decode call ``qkv``/``out`` around their own attention."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        hd = cfg.head_size
        self.wq = _dense(cfg, cfg.d_model, cfg.n_heads * hd, device)
        self.wk = _dense(cfg, cfg.d_model, cfg.kv_heads * hd, device)
        self.wv = _dense(cfg, cfg.d_model, cfg.kv_heads * hd, device)
        self.wo = _dense(cfg, cfg.n_heads * hd, cfg.d_model, device)

    def qkv(self, x: torch.Tensor):
        """x [B, S, d] → q [B, S, H, D], k and v [B, S, KV, D].

        The head counts are the projections' own: under tensor
        parallelism ``wq``/``wk``/``wv`` give this rank's ``H/tp`` and
        ``KV/tp`` heads (the plans shard a head dim only where ``tp``
        divides its count, so the GQA group ratio stays ``H/KV``)."""
        B, S, _ = x.shape
        hd = self.cfg.head_size
        q = self.wq(x).view(B, S, -1, hd)
        k = self.wk(x).view(B, S, -1, hd)
        v = self.wv(x).view(B, S, -1, hd)
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """o [B, S, H, D] → [B, S, d]."""
        B, S = o.shape[:2]
        return self.wo(o.reshape(B, S, -1))

    def forward(self, x, *, angles=None, bias=None, causal=True,
                segment_ids=None):
        q, k, v = self.qkv(x)
        if angles is not None:
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        o = self.attn_fn(q, k, v, causal=causal,
                         **_optional_attn_kwargs(bias, segment_ids))
        return self.out(o)


class CrossAttention(nn.Module):
    """Attention of ``x`` (queries) over ``kv`` (an encoder's output),
    never causal; ``segment_ids`` is a ``([B, S_q], [B, S_kv])`` pair for
    packed encoder-decoder batches, so each decoder position attends only
    its own document's encoder span.  No biases on its projections, as in
    the JAX module."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        hd = cfg.head_size
        self.wq = _dense(cfg, cfg.d_model, cfg.n_heads * hd, device, False)
        self.wk = _dense(cfg, cfg.d_model, cfg.kv_heads * hd, device, False)
        self.wv = _dense(cfg, cfg.d_model, cfg.kv_heads * hd, device, False)
        self.wo = _dense(cfg, cfg.n_heads * hd, cfg.d_model, device, False)

    def forward(self, x, kv, *, bias=None, segment_ids=None):
        B, S, _ = x.shape
        T, hd = kv.shape[1], self.cfg.head_size
        q = self.wq(x).view(B, S, -1, hd)  # local heads, as in Attention
        k = self.wk(kv).view(B, T, -1, hd)
        v = self.wv(kv).view(B, T, -1, hd)
        o = self.attn_fn(q, k, v, causal=False,
                         **_optional_attn_kwargs(bias, segment_ids))
        return self.wo(o.reshape(B, S, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.activation = cfg.activation
        if cfg.activation == "silu":  # SwiGLU
            self.w_gate = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.w_up = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.w_down = _dense(cfg, cfg.d_ff, cfg.d_model, device)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The activations ``w_down`` takes: [..., d_ff], or this rank's
        ``d_ff/tp`` columns under tensor parallelism."""
        if self.activation == "silu":
            return F.silu(self.w_gate(x)) * self.w_up(x)
        return F.gelu(self.w_up(x), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(self.hidden(x))


def moe_capacity(moe, n_tokens: int) -> int:
    """Rows of each expert's buffer when ``n_tokens`` tokens are routed
    under ``moe`` (a ``MoEConfig``): the JAX ``MoEMLP``'s formula, in
    Python floats."""
    return max(1, int(math.ceil(n_tokens * moe.top_k / moe.n_experts * 1.25)))


class MoEMLP(nn.Module):
    """Capacity-based token-choice mixture of experts (the Switch/GShard
    dispatch of the JAX package's ``MoEMLP``): an f32 router, top-k gates
    renormalized, each (token, choice) given a slot in its expert's
    buffer of ``capacity`` rows in token-major order (pairs past it are
    dropped), then one-hot dispatch and combine einsums around SwiGLU
    experts.  The expert weights keep the JAX layout, ``[E, d, ff]`` and
    ``[E, ff, d]``.

    Each call stores which of this rank's (token, choice) pairs found a
    slot as ``kept`` ([T, k] bool) and the load-balancing loss (GShard
    eq. 4) as ``aux``,
    keeping only the last, as the JAX module's keep-last ``sow`` does: a
    recompute under ``remat="full"`` overwrites it with the same value and
    the loss, already formed, counts it once.  :func:`router_aux_loss`
    sums it over a model.

    ``parallel`` is None on one device.  On a mesh the train step sets it
    (``parallel.spmd.ExpertParallel``): capacity, slots and the loss are
    then global over the data shards of the batch and the sequence
    chunks of ``sp``, as if one device routed the whole batch, and this
    rank holds and runs only its slice of the experts."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
        self.router = Linear(d, E, False, dtype=torch.float32,
                             param_dtype=torch.float32, device=device)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.w_gate = self._experts(E, d, ff, kw)
        self.w_up = self._experts(E, d, ff, kw)
        self.w_down = self._experts(E, ff, d, kw)
        self.parallel = None
        self.kept: Optional[torch.Tensor] = None
        self.aux: Optional[torch.Tensor] = None

    @staticmethod
    def _experts(E: int, n_in: int, n_out: int, kw) -> nn.Parameter:
        """An ``[E, n_in, n_out]`` stack, drawn as soon as it is created:
        a replay of the recording then holds one full stack at a time.
        flax's lecun_normal on such a kernel takes the expert dim as
        receptive field: fan_in = E * n_in."""
        w = nn.Parameter(torch.empty(E, n_in, n_out, **kw))
        trunc_normal_(w, math.sqrt(1.0 / (E * n_in)) / _TRUNC_STD)
        return w

    def route(self, probs: torch.Tensor, dtype: torch.dtype):
        """Top-k routing of ``probs`` (``[B, S, E]`` f32: this rank's rows,
        and its chunk of them under sequence parallelism): ``(gates [T,
        k], onehot [T, k, E], pos [T, k], capacity)``, ``pos`` each
        (token, choice)'s slot in its expert's buffer in the token-major
        order of the whole batch.  Sets ``kept`` and ``aux`` (the routed
        fractions rounded to ``dtype``, the activations', as the JAX
        module's one-hot mean is)."""
        moe, par = self.cfg.moe, self.parallel
        B, S, E = probs.shape
        T, k = B * S, moe.top_k
        gate_vals, gate_idx = torch.topk(probs.reshape(T, E), k, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        with torch.no_grad():
            onehot = F.one_hot(gate_idx, E)  # [T, k, E]
            rows = onehot.reshape(B, S * k, E)
            if par is None:
                pos = rows.reshape(T * k, E).cumsum(0) - 1
                total, n_tok = rows.sum((0, 1)), T
            else:
                # Each row's pairs before this rank's first in the
                # whole batch: a cumsum restarted at each row, offset.
                before, total = par.route_counts(rows.sum(1))
                pos = rows.cumsum(1) - 1 + before[:, None]
                n_tok = T * par.n_data * par.n_seq
            capacity = moe_capacity(moe, n_tok)
            pos = (pos.reshape(T, k, E) * onehot).sum(-1)
            self.kept = pos < capacity  # [T, k]: False where dropped

        whole = probs if par is None else par.gather_seq(probs)
        me = whole.reshape(-1, E).sum(0)
        if par is not None:
            me = par.sum_data(me)
        me = me / n_tok
        ce = (total.float() / n_tok).to(dtype)  # fraction routed
        self.aux = (me * ce).sum() * E * moe.router_aux_weight
        return gate_vals, onehot, pos, capacity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        par, dt = self.parallel, x.dtype
        B, S, D = x.shape
        T, E = B * S, self.cfg.moe.n_experts
        xt = x.reshape(T, D)
        probs = torch.softmax(self.router(xt), dim=-1)  # [T, E] f32
        gate_vals, onehot, pos, capacity = self.route(probs.view(B, S, E), dt)

        with torch.no_grad():
            slot = torch.where(self.kept, pos, capacity)
            po = F.one_hot(slot, capacity + 1)[..., :capacity].to(dt)
            eo = onehot.to(dt)  # [T, k, E]
            lo, n = (0, E) if par is None else (par.expert_offset, par.n_local)
            eo_local = eo[..., lo:lo + n]
            disp = torch.einsum("tke,tkc->tec", eo_local, po)  # 0/1

        gates = gate_vals.to(dt)
        if par is not None:
            xt, gates = par.enter(xt), par.enter(gates)
        comb = torch.einsum("tke,tkc->tec", eo_local * gates[..., None], po)
        expert_in = torch.einsum("tec,td->ecd", disp, xt)  # [E, C, d]
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, self.w_gate.to(dt)))
        h = h * torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(dt))
        expert_out = torch.einsum("ecf,efd->ecd", h, self.w_down.to(dt))
        out = torch.einsum("tec,ecd->td", comb, expert_out)
        if par is not None:
            out = par.leave(out)
        return out.reshape(B, S, D)


def router_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the last load-balancing loss of every :class:`MoEMLP`
    in ``model`` (0 without one), as the JAX trainer sums the ``losses``
    collection."""
    terms = [m.aux.float() for m in model.modules()
             if isinstance(m, MoEMLP) and m.aux is not None]
    if not terms:
        p = next(model.parameters(), None)
        return torch.zeros((), device=None if p is None else p.device)
    return torch.stack(terms).sum()


class Block(nn.Module):
    """Pre-norm transformer block; its MLP is a :class:`MoEMLP` named
    ``moe`` when the config has ``moe`` set.  ``causal`` is an argument of
    ``forward`` (False for encoders: T5's and ViT's)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.norm_0 = make_norm(cfg, device)
        self.attn = Attention(cfg, device, attn_fn)
        self.norm_1 = make_norm(cfg, device)
        if cfg.moe is not None:
            self.moe = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, *, angles=None, causal=True, segment_ids=None):
        x = x + self.attn(self.norm_0(x), angles=angles, causal=causal,
                          segment_ids=segment_ids)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.norm_1(x))


def run_block(cfg: TransformerConfig, blk: nn.Module, x: torch.Tensor,
              **kwargs) -> torch.Tensor:
    """``blk(x, **kwargs)`` under ``cfg.remat``: with ``"full"`` and
    gradients on, through ``torch.utils.checkpoint`` (non-reentrant), the
    counterpart of flax's ``nn.remat(Block)``: only the block's input is
    kept, and its forward runs again in the backward."""
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', not {cfg.remat!r}")
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(blk, x, use_reentrant=False, **kwargs)
    return blk(x, **kwargs)
