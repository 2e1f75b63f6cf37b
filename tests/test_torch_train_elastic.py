"""``parallel.train_elastic``: the train step under the elastic loop.

On a TINY-sized llama (float32, the CPU, the flash attention function's
plain versions), 8 steps on numpy-seeded batches, checkpoints every 2
steps with ``max_to_keep=2``, under the plan
``save@4=corrupt:truncate;step@5=raise;step@6=preempt``: the step-4
save is damaged after it committed, step 5 raises, the restore finds
step 4 corrupt, quarantines it (``step_4.corrupt``) and restores step 2
in place (parameters, AdamW's moments and step counters, the step
count); step 6's preemption notice drains the run to ``CLEAN_EXIT.json``
at step 6, and a second ``train_elastic`` on a freshly initialized model
resumes there and runs steps 7 and 8.

* the port's losses, step by step (a replayed step's last value), are
  bitwise those of one uninterrupted ``make_train_step`` run from the
  same weights, with one restart;
* they are within 1e-5 relative of the JAX ``train_elastic``'s under the
  same plan, from the same flax weights (``from_flax_params``), the JAX
  step jitted as ``tests/test_torch_train.py`` takes it.

And the shrink of a mesh: a checkpoint written by 2 gloo ranks training
on ``{fsdp: 2}`` (FSDP2 shards of the parameters and moments, each rank
its own file) resumes in the test's process without a mesh, through
``needs_reshard`` -> ``restore_resharded``, and its steps equal an
uninterrupted run from the same resharded state bit for bit.  No JAX at
module level: the spawned ranks import this module.
"""

import functools
import json

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params, make_llama
from torchdistx_tpu_torch.parallel import make_train_step, train_elastic

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=64)
PLAN = "save@4=corrupt:truncate;step@5=raise;step@6=preempt"
STEPS = 8
ELASTIC = dict(checkpoint_every=2, max_to_keep=2, probe_on_restart=False)


def _batches():
    rng = np.random.RandomState(7)
    return [rng.randint(0, SHAPE["vocab_size"], (2, 16)).astype(np.int32)
            for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _flax_params():
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import TransformerConfig as JaxConfig
    from torchdistx_tpu.models import make_llama as jax_make_llama

    jcfg = JaxConfig(dtype=jnp.float32, **SHAPE)
    params = jax.jit(jax_make_llama(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _model(seed=None):
    """The flax weights, or (``seed``) other ones a resume overwrites."""
    cfg = TransformerConfig(dtype=torch.float32, **SHAPE)
    if seed is not None:
        torch.manual_seed(seed)
    model = make_llama(cfg, device="cpu")
    if seed is None:
        model.load_state_dict(from_flax_params("llama", cfg, _flax_params()))
    return cfg, model


def _elastic(run, tmp, chaos_pkg, make_state):
    """Both runs of one package (interrupted, then resumed): the loss of
    each step (its last value), the two results and what is on disk."""
    losses = {}

    def on_metrics(step, metrics):
        losses[step] = float(metrics["loss"])

    chaos_pkg.install(PLAN)
    try:
        first = run(make_state(), on_metrics, resume=False)
    finally:
        chaos_pkg.clear()
    second = run(make_state(1), on_metrics, resume=True)
    clean = json.loads((tmp / "CLEAN_EXIT.json").read_text())["step"]
    dirs = sorted(p.name for p in tmp.iterdir() if p.name.startswith("step_"))
    return losses, first, second, clean, dirs


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's interrupted and resumed runs, and one uninterrupted
    ``make_train_step`` run's losses from the same weights."""
    from torchdistx_tpu_torch import chaos

    tmp = tmp_path_factory.mktemp("train_elastic")
    batches = _batches()
    cfg, model = _model()
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device="cpu")
    state = init_state(model)
    want = []
    for b in batches:
        state, metrics = train_step(state, shard_batch(b))
        want.append(float(metrics["loss"]))

    def run(made, on_metrics, resume):
        cfg, model = made
        state, steps, restarts = train_elastic(
            model, cfg, batches, device="cpu", checkpoint_dir=str(tmp),
            on_metrics=on_metrics, resume=resume, **ELASTIC)
        return steps, restarts, state["step"]

    return want, _elastic(run, tmp, chaos, _model)


def test_resumed_run_is_bitwise(port_run):
    want, (losses, first, second, clean, dirs) = port_run
    assert first == (6, 1, 6) and second == (8, 0, 8)
    assert clean == 6
    assert dirs == ["step_4.corrupt", "step_6", "step_8"]
    assert [losses[s] for s in range(1, STEPS + 1)] == want


def test_losses_match_jax_train_elastic(port_run, tmp_path):
    """The JAX package's loop under the same plan, from the same
    weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchdistx_tpu import chaos as jax_chaos
    from torchdistx_tpu.models import TransformerConfig as JaxConfig
    from torchdistx_tpu.models import make_llama as jax_make_llama
    from torchdistx_tpu.parallel.train import train_elastic as jax_train_elastic

    _, (losses, first, second, clean, dirs) = port_run
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPE)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    batches = [jnp.asarray(b) for b in _batches()]

    def jax_run(params, on_metrics, resume):
        state, steps, restarts = jax_train_elastic(
            jax_make_llama(jcfg), jcfg, mesh, params, batches,
            checkpoint_dir=str(tmp_path), on_metrics=on_metrics,
            resume=resume, **ELASTIC)
        return steps, restarts, int(state["step"])

    params = jax.tree.map(jnp.asarray, _flax_params())
    jlosses, jfirst, jsecond, jclean, jdirs = _elastic(
        jax_run, tmp_path, jax_chaos, lambda seed=None: params)
    assert (jfirst, jsecond, jclean, jdirs) == (first, second, clean, dirs)
    for s in range(1, STEPS + 1):
        assert losses[s] == pytest.approx(jlosses[s], rel=1e-5), s


def _rank(rank, world, tmp):
    """2 steps of ``train_elastic`` on a gloo ``{fsdp: 2}`` mesh from the
    keyed values: the step-2 checkpoint holds each rank's FSDP2 shards of
    the parameters and AdamW's moments."""
    import torch.distributed as dist

    from torchdistx_tpu_torch import deferred_init
    from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
    from torchdistx_tpu_torch.models.plans import decoder_lm_plan
    from torchdistx_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    try:
        cfg = TransformerConfig(dtype=torch.float32, **SHAPE)
        mesh = make_mesh({"fsdp": world}, device_type="cpu")
        model = deferred_init(make_llama, cfg, device="cpu")
        bind_values(model, materialize_module_cuda(
            model, mesh=mesh, plan=decoder_lm_plan(cfg)))
        train_elastic(model, cfg, _batches()[:2], mesh=mesh, device="cpu",
                      checkpoint_dir=f"{tmp}/ck", checkpoint_every=2,
                      probe_on_restart=False)
    finally:
        dist.destroy_process_group()


def test_two_rank_checkpoint_resumes_on_one_process(tmp_path):
    """A checkpoint of FSDP2 shards from 2 gloo ranks, resumed by one
    process without a mesh: ``needs_reshard`` routes it through
    ``restore_resharded``, and the resumed steps equal, bit for bit,
    an uninterrupted run from the same resharded state."""
    import torch.multiprocessing as mp

    from torchdistx_tpu_torch import observe, reshard
    from torchdistx_tpu_torch.utils.checkpoint import read_manifest

    mp.spawn(_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    ck = tmp_path / "ck" / "step_2"
    topo = read_manifest(ck)["topology"]
    assert topo["mesh_axes"] == {"fsdp": 2}
    assert topo["specs"]["opt.exp_avg.blocks.0.attn.wq.weight"] == \
        topo["specs"]["params.blocks.0.attn.wq.weight"] != "()"
    losses = {}
    before = observe.counters().counter("tdx.reshard.elastic_reshards").value
    cfg, model = _model(seed=3)
    state, steps, _ = train_elastic(
        model, cfg, _batches()[:4], device="cpu",
        checkpoint_dir=str(tmp_path / "ck"), resume=True,
        probe_on_restart=False,
        on_metrics=lambda s, m: losses.setdefault(s, float(m["loss"])))
    assert steps == 4 and sorted(losses) == [3, 4]
    assert observe.counters().counter(
        "tdx.reshard.elastic_reshards").value == before + 1
    cfg, model = _model(seed=4)
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device="cpu")
    ref = reshard.restore_resharded(ck, init_state(model))
    assert ref["step"] == 2
    for s, b in zip((3, 4), _batches()[2:4]):
        ref, metrics = train_step(ref, shard_batch(b))
        assert float(metrics["loss"]) == losses[s], s
