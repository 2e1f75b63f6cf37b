"""Ring-flash attention (``parallel/ring_flash.py``) against the JAX
package's ``make_ring_flash_attention`` on the same numpy inputs.

The port's contract is the JAX ``shard_map``'s per-device one: each rank
passes its sequence chunk and gets its chunk of the output.  One spawn of
4 gloo CPU ranks (a file rendezvous under a temporary directory) runs
every case and saves each rank's chunks; the tests put the chunks back in
rank order and hold them against the JAX function's global result, which
runs on a ``{dp: 2, sp: 4}`` mesh of ``conftest.py``'s 8 virtual CPU
devices with the Pallas kernels in interpret mode.  On the CPU the port's
kernels run their plain versions.

Sizes and bands are the JAX suite's (``tests/test_parallel.py``
``TestRingFlash``): B 2, S 32, H 4, D 16, float32; forward within 1e-5,
gradients (of ``sum(out ** 2)``) within 1e-4.  Cases: causal and not x
KV in {4, 2} (forward), gradients both ways, packed segment ids, an
additive [H, S, S] bias with its gradient, and on a ``{dp: 2, sp: 2}``
mesh: gradients, a causal cross-attention of other lengths (to the dense
ring) and the checks that raise.  No JAX at module level: the spawned
ranks import this module.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

WORLD = 4
B, S, H, D = 2, 32, 4, 16
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# case: (causal, kv heads, with gradients, extra) on the {sp: 4} mesh
CASES = {
    "fwd-causal-kv4": (True, 4, False, None),
    "fwd-causal-kv2": (True, 2, True, None),
    "fwd-full-kv4": (False, 4, False, None),
    "fwd-full-kv2": (False, 2, True, None),
    "segs-causal": (True, 4, True, "segs"),
    "segs-full": (False, 4, True, "segs"),
    "bias-causal": (True, 4, True, "bias"),
    "bias-full": (False, 4, True, "bias"),
}


def _inputs(kv: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    seg = np.concatenate([np.zeros((B, 12)), np.ones((B, 8)),
                          np.full((B, 12), 2)], 1).astype(np.int32)
    return {"q": rng.randn(B, S, H, D).astype(np.float32),
            "k": rng.randn(B, S, kv, D).astype(np.float32),
            "v": rng.randn(B, S, kv, D).astype(np.float32),
            "bias": rng.randn(H, S, S).astype(np.float32), "seg": seg}


def _rank_case(attn, x: dict, causal: bool, extra, rows, r: int, n: int):
    """This rank's chunks (batch ``rows``, sequence chunk ``r`` of ``n``)
    through ``attn``: the output and, for a case with gradients, those of
    q, k, v and the bias rows under ``sum(out ** 2)``."""
    def chunk(a, dim=1):
        s = a.shape[dim] // n
        return torch.from_numpy(a).narrow(dim, r * s, s)

    q, k, v = (chunk(x[name][rows]).clone().requires_grad_()
               for name in ("q", "k", "v"))
    kw = {}
    if extra == "bias":
        kw["bias"] = chunk(x["bias"]).clone().requires_grad_()
    if extra == "segs":
        kw["segment_ids"] = chunk(x["seg"][rows])
    out = attn(q, k, v, causal=causal, **kw)
    (out ** 2).sum().backward()
    res = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    if extra == "bias":
        res["dbias"] = kw["bias"].grad.numpy()
    return res


def _checks(mesh) -> dict:
    """The refusals: causal ring-flash of unequal chunks, a bias not
    row-sharded [H, s, T_total]."""
    from torchdistx_tpu_torch.parallel import ring_flash_attention

    q = torch.zeros(B, 8, H, D)
    got = {"causal_unequal": False, "bias_shape": False}
    try:
        ring_flash_attention(q, q[:, :4], q[:, :4], mesh=mesh, causal=True)
    except NotImplementedError as e:
        got["causal_unequal"] = "equal q/k chunk" in str(e)
    try:
        ring_flash_attention(q, q, q, mesh=mesh, causal=False,
                             bias=torch.zeros(H, 8, 8))
    except ValueError as e:
        got["bias_shape"] = "row-sharded" in str(e)
    return got


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from torchdistx_tpu_torch.parallel import (
        make_mesh,
        make_ring_flash_attention,
    )

    try:
        out = {}
        mesh = make_mesh({"sp": world}, device_type="cpu")
        attn = make_ring_flash_attention(mesh)
        for name, (causal, kv, _, extra) in CASES.items():
            res = _rank_case(attn, _inputs(kv), causal, extra,
                             slice(None), rank, world)
            out.update({f"{name}/{k}": a for k, a in res.items()})
        mesh = make_mesh({"dp": 2, "sp": 2}, device_type="cpu")
        attn = make_ring_flash_attention(mesh)
        b, r = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
        rows = slice(b, b + 1)
        res = _rank_case(attn, _inputs(2), True, None, rows, r, 2)
        out.update({f"dp2-sp2/{k}": a for k, a in res.items()})
        x = _inputs(4)
        x["q"] = x["q"][:, :16]  # cross-attention: 16 queries, 32 keys
        res = _rank_case(attn, x, True, None, rows, r, 2)
        out.update({f"cross-causal/{k}": a for k, a in res.items()})
        checks = _checks(mesh)
        out.update({f"checks/{k}": np.array(v) for k, v in checks.items()})
    finally:
        dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_flash")
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _gathered(ranks, key: str, mesh: str = "sp4") -> np.ndarray:
    """The ranks' chunks in place: over the sequence (dim 1, the bias
    gradient's rows likewise) and, on {dp 2, sp 2}, the batch rows."""
    if mesh == "sp4":
        return np.concatenate([r[key] for r in ranks], 1)
    # rank = dp * 2 + sp
    rows = [np.concatenate([ranks[b * 2 + s][key] for s in range(2)], 1)
            for b in range(2)]
    return np.concatenate(rows, 0)


@functools.lru_cache(maxsize=None)
def _jax_mesh(axes):
    from torchdistx_tpu.parallel import make_mesh

    return make_mesh(dict(axes))


def _jax_case(causal: bool, kv: int, grads: bool, extra, q_len: int = S):
    """The JAX ring-flash attention's global output (and gradients) on a
    {dp: 2, sp: 4} mesh of the 8 virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel import make_ring_flash_attention

    attn = make_ring_flash_attention(_jax_mesh((("dp", 2), ("sp", 4))))
    x = _inputs(kv)
    q, k, v = (jnp.asarray(x[n]) for n in ("q", "k", "v"))
    q = q[:, :q_len]
    bias = jnp.asarray(x["bias"])
    seg = jnp.asarray(x["seg"])

    def f(q, k, v, bias):
        kw = {}
        if extra == "bias":
            kw["bias"] = bias
        if extra == "segs":
            kw["segment_ids"] = seg
        out = attn(q, k, v, causal=causal, **kw)
        return (out ** 2).sum(), out

    if not grads:
        return {"out": np.asarray(jax.jit(f)(q, k, v, bias)[1])}
    (_, out), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                             has_aux=True))(q, k, v, bias)
    res = {"out": np.asarray(out)}
    res.update({n: np.asarray(a) for n, a in zip(("dq", "dk", "dv"), g)})
    if extra == "bias":
        res["dbias"] = np.asarray(g[3])
    return res


def _compare(got_of, want: dict):
    for key, w in want.items():
        tol = FWD_TOL if key == "out" else GRAD_TOL
        err = float(np.abs(got_of(key) - w).max())
        assert err < tol, f"{key}: {err} >= {tol}"


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("fwd")])
def test_forward_matches_jax(ranks, case):
    causal, kv, grads, extra = CASES[case]
    want = _jax_case(causal, kv, grads, extra)
    _compare(lambda key: _gathered(ranks, f"{case}/{key}"), want)


@pytest.mark.parametrize("case", ["segs-causal", "segs-full"])
def test_segment_ids_match_jax(ranks, case):
    """Packed sequences: the query ids local, the key ids gathered over sp
    (the model passes one [B, s] tensor) and column-sliced per step."""
    want = _jax_case(*CASES[case])
    _compare(lambda key: _gathered(ranks, f"{case}/{key}"), want)


@pytest.mark.parametrize("case", ["bias-causal", "bias-full"])
def test_bias_and_dbias_match_jax(ranks, case):
    """The bias's rows [H, s, T_total] on each rank, one contiguous [H, s,
    t] strip per ring step, and its gradient written strip by strip."""
    want = _jax_case(*CASES[case])
    _compare(lambda key: _gathered(ranks, f"{case}/{key}"), want)


def test_data_axis_cross_attention_and_checks(ranks):
    """On {dp: 2, sp: 2}: the gradients; a causal cross-attention of 16
    queries over 32 keys (routed to the dense ring, bottom-right
    aligned); causal chunks of unequal length and a bias of the wrong
    shape refused."""
    want = _jax_case(True, 2, True, None)
    _compare(lambda key: _gathered(ranks, f"dp2-sp2/{key}", "dp2-sp2"), want)
    want = _jax_case(True, 4, True, None, q_len=16)
    _compare(lambda key: _gathered(ranks, f"cross-causal/{key}", "dp2-sp2"),
             want)
    for r in ranks:
        assert bool(r["checks/causal_unequal"]) and bool(r["checks/bias_shape"])
