"""The train step's ``sp`` axis and the models on a sequence chunk.

One spawn of 4 gloo CPU ranks (a file rendezvous under a temporary
directory) runs every case and writes what each rank saw; the tests read
it.  float32, TINY shapes, 3 AdamW steps:

* against the JAX package: the same flax llama weights (numpy, then
  ``from_flax_params``) on a ``{dp: 2, sp: 2}`` gloo mesh with
  ``make_ring_flash_attention``, and the JAX ``make_train_step`` over
  ``make_mesh({"dp": 2, "sp": 2})`` of 4 of ``conftest.py``'s 8 virtual
  CPU devices with the JAX ring-flash attention: losses and gradient
  norms within 1e-5 relative;
* against the port's unsharded step (``mesh=None``) from the same keyed
  values: ``{dp: 2, sp: 2}``, ``{fsdp: 2, sp: 2}`` and ``{sp: 2, tp:
  2}``, losses and gradient norms within 1e-5 relative and equal on
  every rank; a packed batch whose document boundaries fall inside a
  chunk and on a chunk's edge, with a padded tail;
* T5 on ``{sp: 4}`` with the ring-flash and the Ulysses attention,
  ``seq_shard`` giving each chunk its rows of the relative-position
  bias: the gathered logits against the JAX dense forward within 2e-4
  (``tests/test_parallel.py`` ``TestT5SequenceParallel``);
* a model whose attention sees only its chunk refused on an sp mesh, a
  mixture of experts trained there (``tests/test_torch_moe_sp.py``
  holds its routing and losses);
* with telemetry on, the step's counted FLOPs and tokens are the whole
  mesh's (the chunks' counts differ under causal masking and are summed
  over sp).

No JAX at module level: the spawned ranks import this module.
"""

import functools
import json
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import (
    TINY,
    TINY_MOE,
    TINY_T5,
    TransformerConfig,
    from_flax_params,
    make_llama,
    make_mixtral,
    make_t5,
)
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    local_shard,
    make_mesh,
    make_ring_flash_attention,
    make_train_step,
    make_ulysses_attention,
    placements_for,
)
from torchdistx_tpu_torch.parallel.sharding import mesh_shape

torch.set_num_threads(2)

WORLD, B, S, STEPS = 4, 4, 32, 3
RTOL = 1e-5
T5_ATOL = 2e-4
MESHES = {"dp2-sp2": {"dp": 2, "sp": 2}, "fsdp2-sp2": {"fsdp": 2, "sp": 2},
          "sp2-tp2": {"sp": 2, "tp": 2}}
JAX_SHAPES = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=128, max_seq_len=64)
T5_B, T5_S = 2, 32


def _batches(vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (STEPS, B, S))


def _packed() -> np.ndarray:
    """[B, S] ids: boundaries inside a chunk (9, 23) and on the edge of the
    two chunks (16), a padded tail (negative id) in one row."""
    seg = np.zeros((B, S), np.int64)
    seg[:, 9:] = 1
    seg[:, 16:] = 2
    seg[1:3, 23:] = 3
    seg[3, 28:] = -1
    return seg


def _trajectory(model, cfg, mesh, batches, seg=None):
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh)
    state = init_state(model)
    losses, norms = [], []
    for toks in batches:
        args = () if seg is None else (shard_batch(seg),)
        state, metrics = train_step(state, shard_batch(toks), *args)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms


@functools.lru_cache(maxsize=None)
def _reference(packed: bool):
    """The ``mesh=None`` trajectory from the keyed unsharded values."""
    ref = deferred_init(make_llama, TINY, device="cpu")
    bind_values(ref, materialize_module_cuda(ref, device="cpu"))
    return _trajectory(ref, TINY, None, _batches(TINY.vocab_size),
                       _packed() if packed else None)


def _case(axes: dict, packed: bool) -> dict:
    mesh = make_mesh(axes, device_type="cpu")
    model = deferred_init(make_llama, TINY,
                          attn_fn=make_ring_flash_attention(mesh), device="cpu")
    bind_values(model, materialize_module_cuda(model, mesh=mesh,
                                               plan=decoder_lm_plan(TINY)))
    losses, norms = _trajectory(model, TINY, mesh, _batches(TINY.vocab_size),
                                _packed() if packed else None)
    ref_losses, ref_norms = _reference(packed)
    return {"losses": losses, "norms": norms, "ref_losses": ref_losses,
            "ref_norms": ref_norms}


def _tree(npz: str) -> dict:
    tree: dict = {}
    for key, leaf in np.load(npz).items():
        node = tree
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _jax_case(npz: str) -> dict:
    """The flax llama weights on a {dp: 2, sp: 2} mesh, ring-flash."""
    from torch.distributed.tensor import DTensor

    cfg = TransformerConfig(dtype=torch.float32, **JAX_SHAPES)
    full = from_flax_params("llama", cfg, _tree(npz))
    mesh = make_mesh({"dp": 2, "sp": 2}, device_type="cpu")
    plan = decoder_lm_plan(cfg)
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    values = {}
    for name, t in full.items():
        spec = plan.spec_for(name, tuple(t.shape), mesh)
        values[name] = DTensor.from_local(
            local_shard(t, spec, shape, coord).contiguous(), mesh,
            placements_for(spec, mesh), run_check=False, shape=t.shape,
            stride=t.stride())
    model = deferred_init(make_llama, cfg,
                          attn_fn=make_ring_flash_attention(mesh), device="cpu")
    bind_values(model, values)
    losses, norms = _trajectory(model, cfg, mesh,
                                _batches(cfg.vocab_size, seed=2))
    return {"losses": losses, "norms": norms}


def _t5_batch():
    rng = np.random.RandomState(5)
    return (rng.randint(0, TINY_T5.vocab_size, (T5_B, T5_S)),
            rng.randint(0, TINY_T5.vocab_size, (T5_B, T5_S)))


def _t5_case(npz: str, rank: int, world: int) -> dict:
    """This rank's logits chunk of TINY_T5 with each sp attention."""
    mesh = make_mesh({"sp": world}, device_type="cpu")
    sd = from_flax_params("t5", TINY_T5, _tree(npz))
    enc, dec = (torch.from_numpy(x).narrow(1, rank * (T5_S // world),
                                           T5_S // world)
                for x in _t5_batch())
    out = {}
    for name, make in (("ring", make_ring_flash_attention),
                       ("ulysses", make_ulysses_attention)):
        model = make_t5(TINY_T5, attn_fn=make(mesh), device="cpu")
        model.load_state_dict(sd)
        with torch.no_grad():
            out[name] = model(enc, dec, seq_shard=(rank, world)).tolist()
    return out


def _checks() -> dict:
    """A refusal on an sp mesh, a mixture of experts taken there, and no
    batch-replication warning on an sp-only one (its ranks hold
    different tokens)."""
    mesh = make_mesh({"sp": WORLD}, device_type="cpu")
    got = {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        model = deferred_init(make_llama, TINY, device="cpu")
        init_state, _, _ = make_train_step(model, TINY, device="cpu",
                                           mesh=mesh)
    got["no_replicated_warning"] = not any("REPLICATED" in str(w.message)
                                           for w in seen)
    bind_values(model, materialize_module_cuda(model, mesh=mesh,
                                               plan=decoder_lm_plan(TINY)))
    try:
        init_state(model)
        got["plain_attention_refused"] = False
    except ValueError as e:
        got["plain_attention_refused"] = "sees only its chunk" in str(e)
    moe = deferred_init(make_mixtral, TINY_MOE,
                        attn_fn=make_ring_flash_attention(mesh), device="cpu")
    bind_values(moe, materialize_module_cuda(moe, mesh=mesh,
                                             plan=decoder_lm_plan(TINY_MOE)))
    init_state, train_step, shard_batch = make_train_step(
        moe, TINY_MOE, device="cpu", mesh=mesh)
    _, metrics = train_step(init_state(moe),
                            shard_batch(_batches(TINY_MOE.vocab_size)[0]))
    got["moe_trains"] = bool(np.isfinite(float(metrics["loss"]))
                             and float(metrics["aux"]) > 0)
    return got


def _telemetry() -> dict:
    """One instrumented step on {dp: 2, sp: 2}: the counted FLOPs and the
    tokens its span reports (tokens/s times the span's seconds)."""
    from torchdistx_tpu_torch import observe

    mesh = make_mesh(MESHES["dp2-sp2"], device_type="cpu")
    model = deferred_init(make_llama, TINY,
                          attn_fn=make_ring_flash_attention(mesh), device="cpu")
    bind_values(model, materialize_module_cuda(model, mesh=mesh,
                                               plan=decoder_lm_plan(TINY)))
    observe.enable(True)
    try:
        init_state, train_step, shard_batch = make_train_step(
            model, TINY, device="cpu", mesh=mesh)
        train_step(init_state(model), shard_batch(_batches(TINY.vocab_size)[0]))
        span = [e for e in observe.tracer().drain()
                if e["ph"] == "X" and e["name"] == "train.step"][0]
    finally:
        observe.enable(False)
    return {"flops_counted": span["args"]["flops_counted"],
            "tokens": span["args"]["tokens_per_s"] * span["dur"] / 1e6}


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # indivisible dims, absent axes
    try:
        out = {name: _case(axes, False) for name, axes in MESHES.items()}
        out["packed"] = _case(MESHES["dp2-sp2"], True)
        out["jax"] = _jax_case(f"{tmp}/llama.npz")
        out["t5"] = _t5_case(f"{tmp}/t5.npz", rank, world)
        out["checks"] = _checks()
        out["telemetry"] = _telemetry()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _flat(params) -> dict:
    from jax.tree_util import tree_flatten_with_path

    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(params)[0]}


@functools.lru_cache(maxsize=None)
def _flax_llama():
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import TransformerConfig as JaxConfig
    from torchdistx_tpu.models import make_llama as jax_make_llama

    jcfg = JaxConfig(dtype=jnp.float32, **JAX_SHAPES)
    params = jax.jit(jax_make_llama(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jcfg, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _flax_t5():
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import TINY_T5 as JAX_TINY_T5
    from torchdistx_tpu.models import make_t5 as jax_make_t5

    enc, dec = (jnp.asarray(x) for x in _t5_batch())
    model = jax_make_t5(JAX_TINY_T5)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), enc, dec)
    logits = jax.jit(model.apply)(params, enc, dec)
    return jax.tree.map(np.asarray, params), np.asarray(logits)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, from one spawn of 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("train_sp")
    np.savez(tmp / "llama.npz", **_flat(_flax_llama()[1]))
    np.savez(tmp / "t5.npz", **_flat(_flax_t5()[0]))
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


def test_losses_match_jax(runs):
    """The JAX ``make_train_step`` over {dp: 2, sp: 2} of 4 virtual CPU
    devices with its ring-flash attention, on the same weights and
    batches."""
    import jax
    import jax.numpy as jnp
    from jax.tree_util import tree_map_with_path

    from torchdistx_tpu.models import make_llama as jax_make_llama
    from torchdistx_tpu.models.plans import decoder_lm_plan as jax_plan
    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel import make_ring_flash_attention as jax_ring
    from torchdistx_tpu.parallel.train import make_train_step as jax_make_step

    jcfg, params = _flax_llama()
    mesh = jax_make_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:WORLD])
    model = jax_make_llama(jcfg, attn_fn=jax_ring(mesh))
    plan = jax_plan()

    def place(path, leaf):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        return jax.device_put(jnp.asarray(leaf),
                              plan.sharding_for(name, leaf.shape, mesh))

    init_state, train_step, shard_batch = jax_make_step(model, jcfg, mesh)
    state = init_state(tree_map_with_path(place, params))
    losses, norms = [], []
    for toks in _batches(JAX_SHAPES["vocab_size"], seed=2):
        state, metrics = train_step(state, shard_batch(jnp.asarray(toks)))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    for out in runs:
        _close(out["jax"]["losses"], losses, "losses vs JAX")
        _close(out["jax"]["norms"], norms, "grad norms vs JAX")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_trajectory_matches_unsharded(runs, mesh):
    """Losses and gradient norms: global (equal on every rank) and within
    1e-5 of ``mesh=None`` on the same keyed values."""
    first = runs[0][mesh]
    for out in runs[1:]:
        assert out[mesh]["losses"] == first["losses"]
        assert out[mesh]["norms"] == first["norms"]
    _close(first["losses"], first["ref_losses"], f"{mesh} losses")
    _close(first["norms"], first["ref_norms"], f"{mesh} grad norms")


def test_packed_boundaries(runs):
    """Next-token targets from the whole row: a chunk's last position is
    scored against the next chunk's first token unless a document
    boundary falls on the chunk's edge; the loss is the global mean over
    the valid targets."""
    first = runs[0]["packed"]
    _close(first["losses"], first["ref_losses"], "packed losses")
    _close(first["norms"], first["ref_norms"], "packed grad norms")


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_t5_matches_jax(runs, attn):
    """TINY_T5 on {sp: 4}: each rank's logits chunk (encoder and decoder
    chunks at their positions, the bias rows from the relative
    positions) against the JAX dense forward."""
    want = _flax_t5()[1]
    got = np.concatenate([np.asarray(out["t5"][attn]) for out in runs], 1)
    np.testing.assert_allclose(got, want, atol=T5_ATOL, rtol=0)


def test_telemetry_counts_global_work(runs):
    """The instrumented step counts the whole mesh's work: every rank's
    ring blocks summed over sp (rank r of sp counts r full blocks and
    its diagonal, together the causal pairs of the whole sequence), times
    the data shards; its tokens are the global batch's."""
    from torchdistx_tpu_torch.models.layers import Linear

    model = make_llama(TINY, device="meta")
    n = sum(m.weight.numel() for m in model.modules() if isinstance(m, Linear))
    attn = 12 * TINY.n_layers * TINY.head_size * TINY.n_heads * B \
        * (S * (S + 1) // 2)
    for out in runs:
        assert out["telemetry"]["flops_counted"] == 6 * n * B * S + attn
        assert out["telemetry"]["tokens"] == pytest.approx(B * S, rel=1e-2)


def test_sp_checks(runs):
    """An sp mesh is taken; a model on the plain attention is refused
    there, a mixture of experts takes a step (finite loss, a router
    loss); an sp-only mesh does not warn that the batch is
    replicated."""
    for out in runs:
        assert all(out["checks"].values()), out["checks"]
