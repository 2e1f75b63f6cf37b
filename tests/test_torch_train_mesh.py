"""The sharded train step (``make_train_step(mesh=)``): FSDP2 and tensor
parallelism over gloo meshes of 4 CPU ranks (a file rendezvous under a
temporary directory), fed by the keyed materializer's values.

One spawn of 4 ranks runs every case and writes what each rank saw; the
tests read it.  Cases (B 8, S 32, 4 AdamW steps, float32):

* TINY llama on ``{fsdp: 4}``, ``{dp: 2, fsdp: 2}`` (HSDP) and ``{fsdp: 2,
  tp: 2}``, TINY_GPT2 (the tied embedding, a vocab-parallel lookup and
  head) on ``{fsdp: 2, tp: 2}``: every parameter's placements after
  ``init_state`` equal ``placements_for(spec, mesh)`` and its local tensor
  is the keyed local shard, bit for bit; the losses and gradient norms of
  the 4 steps agree within 1e-5 relative with ``mesh=None`` run on the
  same seed's unsharded values, and are equal on every rank; after the 4
  steps each parameter's ``full_tensor()`` agrees within 1e-5 normwise —
  GPT-2's key biases aside: their gradient is zero in exact arithmetic,
  AdamW turns its rounding noise into steps of about the learning rate
  on both sides, so they are held to that step bound instead;
* TINY llama on ``{fsdp: 2, tp: 2}`` with packed ``segment_ids`` whose
  valid targets differ from row to row (so from rank to rank): the loss
  is the global sum over valid targets by their global count, within
  1e-5 of ``mesh=None``;
* against the JAX package: the same flax weights (numpy, then
  ``from_flax_params``) sharded by the plan on a ``{fsdp: 2, tp: 2}``
  gloo mesh, and the JAX ``make_train_step`` over ``make_mesh({"fsdp":
  2, "tp": 2})`` of 4 of its 8 virtual CPU devices: the 4-step losses
  and gradient norms agree within 1e-5 relative.

Also: a mesh with no data axis warns that the batch is replicated, a
batch the data shards do not divide raises, and the tensor-parallel
styles follow the plan or raise naming the parameter.  The unported
axes and options raising are in ``test_torch_train.py``.
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
    TINY_GPT2,
    TransformerConfig,
    from_flax_params,
    make_gpt2,
    make_llama,
)
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    local_shard,
    make_mesh,
    make_train_step,
    placements_for,
)
from torchdistx_tpu_torch.parallel.sharding import mesh_shape
from torchdistx_tpu_torch.parallel.spmd import layout_of

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

WORLD, B, S, STEPS = 4, 8, 32, 4
LR = 3e-4  # default_optimizer's
RTOL = 1e-5
MESHES = {"fsdp4": {"fsdp": 4}, "dp2-fsdp2": {"dp": 2, "fsdp": 2},
          "fsdp2-tp2": {"fsdp": 2, "tp": 2}}
# case: (family, mesh, packed)
CASES = {
    "llama-fsdp4": ("llama", "fsdp4", False),
    "llama-dp2-fsdp2": ("llama", "dp2-fsdp2", False),
    "llama-fsdp2-tp2": ("llama", "fsdp2-tp2", False),
    "gpt2-fsdp2-tp2": ("gpt2", "fsdp2-tp2", False),
    "llama-packed-fsdp2-tp2": ("llama", "fsdp2-tp2", True),
}
FAMILIES = {"llama": (make_llama, TINY), "gpt2": (make_gpt2, TINY_GPT2)}
# The flax weights of the JAX comparison (head dim 16).
JAX_SHAPES = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=128, max_seq_len=64)
JAX_MESH = {"fsdp": 2, "tp": 2}


def _batches(vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (STEPS, B, S))


def _packed(seed: int = 1) -> np.ndarray:
    """[B, S] segment ids: two or three documents and a padded tail
    (negative id) of its own length in every row."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(4, S - 8), 2, replace=False))
        pad = rng.randint(0, 8)
        row = np.zeros(S, np.int64)
        row[cuts[0]:] = 1
        row[cuts[1]:] = 2
        if pad:
            row[S - pad:] = -1
        rows.append(row)
    return np.stack(rows)


def _trajectory(init_state, train_step, shard_batch, model, batches, seg):
    state = init_state(model)
    losses, norms = [], []
    for toks in batches:
        args = () if seg is None else (shard_batch(seg),)
        state, metrics = train_step(state, shard_batch(toks), *args)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


def _full(p: torch.Tensor) -> torch.Tensor:
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def _layouts(model, values, full, plan, mesh) -> dict:
    """Per parameter after ``init_state``: whether its placements are the
    plan's and its local tensor is the keyed local shard, bitwise."""
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    out = {}
    for name, p in model.named_parameters():
        spec = plan.spec_for(name, tuple(p.shape), mesh)
        local = p.to_local() if hasattr(p, "to_local") else p
        out[name] = {
            "placements": layout_of(p, mesh) == placements_for(spec, mesh),
            "keyed_shard": torch.equal(local, values[name].to_local())
            and torch.equal(local, local_shard(full[name], spec, shape, coord)),
        }
    return out


@functools.lru_cache(maxsize=None)
def _reference(family: str, packed: bool):
    """The keyed unsharded values of ``family`` and the ``mesh=None``
    trajectory from them (once per rank, shared by the meshes)."""
    make, cfg = FAMILIES[family]
    batches, seg = _batches(cfg.vocab_size), _packed() if packed else None
    ref = deferred_init(make, cfg, device="cpu")
    full = materialize_module_cuda(ref, device="cpu")
    bind_values(ref, full)
    full = {n: t.clone() for n, t in full.items()}  # training moves them
    _, ref_losses, ref_norms = _trajectory(
        *make_train_step(ref, cfg, device="cpu"), ref, batches, seg)
    want = {n: p.detach() for n, p in ref.named_parameters()}
    return full, ref_losses, ref_norms, want


def _case(family: str, axes: dict, packed: bool) -> dict:
    make, cfg = FAMILIES[family]
    batches, seg = _batches(cfg.vocab_size), _packed() if packed else None
    full, ref_losses, ref_norms, want = _reference(family, packed)
    mesh = make_mesh(axes, device_type="cpu")
    plan = decoder_lm_plan(cfg)
    model = deferred_init(make, cfg, device="cpu")
    values = materialize_module_cuda(model, mesh=mesh, plan=plan)
    bind_values(model, values)
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh)
    layouts = {}

    def init(m):
        state = init_state(m)
        layouts.update(_layouts(m, values, full, plan, mesh))
        return state

    _, losses, norms = _trajectory(init, train_step, shard_batch, model,
                                   batches, seg)
    final = {}
    for name, p in model.named_parameters():
        got, w = _full(p.detach()), want[name]
        final[name] = {"rel": float((got - w).norm() / w.norm().clamp_min(1e-30)),
                       "max_abs": float((got - w).abs().max())}
    return {"layouts": layouts, "losses": losses, "norms": norms,
            "ref_losses": ref_losses, "ref_norms": ref_norms, "final": final}


def _jax_case(npz: str) -> dict:
    """The flax weights sharded by the plan on a {fsdp: 2, tp: 2} mesh."""
    from torch.distributed.tensor import DTensor

    flat = dict(np.load(npz))
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    cfg = TransformerConfig(dtype=torch.float32, **JAX_SHAPES)
    full = from_flax_params("llama", cfg, tree)
    mesh = make_mesh(JAX_MESH, device_type="cpu")
    plan = decoder_lm_plan(cfg)
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    values = {}
    for name, t in full.items():
        spec = plan.spec_for(name, tuple(t.shape), mesh)
        values[name] = DTensor.from_local(
            local_shard(t, spec, shape, coord).contiguous(), mesh,
            placements_for(spec, mesh), run_check=False, shape=t.shape,
            stride=t.stride())
    model = deferred_init(make_llama, cfg, device="cpu")
    bind_values(model, values)
    _, losses, norms = _trajectory(
        *make_train_step(model, cfg, device="cpu", mesh=mesh), model,
        _batches(cfg.vocab_size, seed=2), None)
    return {"losses": losses, "norms": norms}


def _batch_checks() -> dict:
    """The reference's warning for a mesh with no data axis, and the
    error for a batch the data shards do not divide."""
    model = deferred_init(make_llama, TINY, device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        make_train_step(model, TINY, device="cpu",
                        mesh=make_mesh({"tp": WORLD}, device_type="cpu"))
    _, _, shard_batch = make_train_step(
        model, TINY, device="cpu",
        mesh=make_mesh({"fsdp": WORLD}, device_type="cpu"))
    try:
        shard_batch(np.zeros((WORLD + 2, S), np.int64))
        raised = False
    except ValueError as e:
        raised = "does not divide" in str(e)
    return {"warns_no_data_axis": any("REPLICATED" in str(w.message)
                                      for w in seen),
            "raises_indivisible_batch": raised}


def _rank(rank: int, world: int, tmp: str, npz: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # indivisible dims, absent axes
    try:
        out = {name: _case(fam, MESHES[mesh], packed)
               for name, (fam, mesh, packed) in CASES.items()}
        out["jax"] = _jax_case(npz)
        out["batch"] = _batch_checks()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _flax_params():
    """TINY-shaped flax llama weights from a seed, as numpy."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import TransformerConfig as JaxConfig
    from torchdistx_tpu.models import make_llama as jax_make_llama

    jcfg = JaxConfig(dtype=jnp.float32, **JAX_SHAPES)
    model = jax_make_llama(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return jcfg, model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, from one spawn of 4 gloo ranks."""
    from jax.tree_util import tree_flatten_with_path

    tmp = tmp_path_factory.mktemp("train_mesh")
    _, _, params = _flax_params()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in tree_flatten_with_path(params)[0]}
    np.savez(tmp / "flax.npz", **flat)
    mp.spawn(_rank, args=(WORLD, str(tmp), str(tmp / "flax.npz")),
             nprocs=WORLD, join=True)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_placements_and_keyed_shards(runs, case):
    for rank, out in enumerate(runs):
        layouts = out[case]["layouts"]
        assert layouts, case
        bad = {n: v for n, v in layouts.items() if not all(v.values())}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_unsharded(runs, case):
    """Losses and gradient norms: global (equal on every rank) and within
    1e-5 of ``mesh=None`` on the same seed's values."""
    first = runs[0][case]
    for out in runs[1:]:
        assert out[case]["losses"] == first["losses"]
        assert out[case]["norms"] == first["norms"]
    _close(first["losses"], first["ref_losses"], f"{case} losses")
    _close(first["norms"], first["ref_norms"], f"{case} grad norms")


@pytest.mark.parametrize("case", list(CASES))
def test_final_parameters_match_unsharded(runs, case):
    for name, err in runs[0][case]["final"].items():
        if name.endswith("attn.wk.bias"):
            # Zero gradient in exact arithmetic: AdamW steps its rounding
            # noise by at most about the learning rate per step.
            assert err["max_abs"] <= STEPS * LR * 1.01, (case, name, err)
        else:
            assert err["rel"] <= RTOL, (case, name, err)


@pytest.mark.parametrize("check", ["warns_no_data_axis",
                                   "raises_indivisible_batch"])
def test_batch_sharding_checks(runs, check):
    assert all(out["batch"][check] for out in runs)


def test_trajectory_matches_jax(runs):
    """The JAX ``make_train_step`` over a {fsdp: 2, tp: 2} mesh of 4
    virtual CPU devices, on the same flax weights and batches."""
    import jax
    import jax.numpy as jnp
    from jax.tree_util import tree_map_with_path

    from torchdistx_tpu.models.plans import decoder_lm_plan as jax_plan
    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.train import make_train_step as jax_make_step

    jcfg, model, params = _flax_params()
    mesh = jax_make_mesh(JAX_MESH, devices=jax.devices()[:WORLD])
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


def _dims(cfg, make, axes):
    """The module (on meta) and each parameter's {axis: tensor dim} under
    ``decoder_lm_plan`` on a mesh of ``axes``."""
    from torchdistx_tpu_torch.parallel.spmd import axis_dims

    model = make(cfg, device="meta")
    plan = decoder_lm_plan(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the head rule's replication
        return model, {
            n: axis_dims(placements_for(plan.spec_for(n, tuple(p.shape), axes),
                                        axes), list(axes))
            for n, p in model.named_parameters()}


def test_tp_styles_follow_the_plan():
    """Attention and MLP inputs column-parallel, outputs row-parallel,
    the vocab-parallel embedding and the gathered head."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from torchdistx_tpu_torch.parallel.spmd import tp_styles

    model, dims = _dims(TINY, make_llama, {"fsdp": 2, "tp": 2})
    styles = tp_styles(model, dims)
    kinds = {n: type(s).__name__ for n, s in styles.items()}
    assert kinds == {
        **{f"blocks.{i}.attn.{w}": "ColwiseParallel"
           for i in range(2) for w in ("wq", "wk", "wv")},
        **{f"blocks.{i}.attn.wo": "RowwiseParallel" for i in range(2)},
        **{f"blocks.{i}.mlp.{w}": "ColwiseParallel"
           for i in range(2) for w in ("w_gate", "w_up")},
        **{f"blocks.{i}.mlp.w_down": "RowwiseParallel" for i in range(2)},
        "embed": "RowwiseParallel", "lm_head": "ColwiseParallel"}
    assert isinstance(styles["embed"], RowwiseParallel)
    assert isinstance(styles["lm_head"], ColwiseParallel)
    _, dims = _dims(TINY, make_llama, {"fsdp": 4})
    assert tp_styles(model, dims) == {}


def test_tp_styles_raise_where_no_style_fits():
    """8 query heads over tp 4 shard wq, 2 kv heads do not shard wk: no
    style gives that, and the error names the parameter and its spec."""
    from torchdistx_tpu_torch.parallel.spmd import tp_styles

    cfg = TINY.replace(n_heads=8, n_kv_heads=2, head_dim=8)
    model, dims = _dims(cfg, make_llama, {"fsdp": 2, "tp": 4})
    with pytest.raises(ValueError, match=r"blocks\.0\.attn\.wk\.weight.*"
                                         r"\(None, 'fsdp'\)"):
        tp_styles(model, dims)
