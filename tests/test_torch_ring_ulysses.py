"""The dense ring (``parallel/ring_attention.py``) and Ulysses
(``parallel/ulysses.py``) against the JAX package's ``make_ring_attention``
and ``make_ulysses_attention`` on the same numpy inputs.

One spawn of 4 gloo CPU ranks (``{sp: 4}``, a file rendezvous under a
temporary directory) runs every case on this rank's sequence chunk and
saves the chunks; the tests put them back in rank order and hold them
against the JAX functions' global results on a ``{dp: 2, sp: 4}`` mesh of
``conftest.py``'s 8 virtual CPU devices.  Forward within 1e-5, gradients
(of ``sum(out ** 2)``) within 1e-4, float32, the JAX suite's sizes
(``tests/test_parallel.py`` ``TestRingAttention``,
``TestUlyssesAttention``).

The dense ring: causal and not, self-attention with gradients, cross-
attention of 16 queries over 32 keys (causal: bottom-right aligned), an
[H, S, S] bias and packed segment ids.  Ulysses: KV 4 (split; also the
bias, segment ids and gradients), KV 2 and 1 (grouped slots), the
ragged gcd grouping (no warning) and H == lcm(n, KV) (warns), the K/V
all-to-alls' head counts (n slots for KV < n, KV·n for the ragged case,
never H), a head count sp does not divide, and no sp axis (the plain
attention).  And the collectives themselves over sp 4, with the
gradients of the differentiable ones.  No JAX at module level: the
spawned ranks import this module.
"""

import functools
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

WORLD = 4
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# name: (strategy, causal, B, S_q, S_k, H, KV, D, extra, grads)
CASES = {
    "ring-self-causal": ("ring", True, 2, 32, 32, 4, 2, 16, None, True),
    "ring-self-full": ("ring", False, 2, 32, 32, 4, 2, 16, None, True),
    "ring-cross-causal": ("ring", True, 2, 16, 32, 4, 4, 8, None, True),
    "ring-cross-full": ("ring", False, 2, 16, 32, 4, 4, 8, None, False),
    "ring-bias-causal": ("ring", True, 2, 32, 32, 4, 4, 16, "bias", True),
    "ring-bias-full": ("ring", False, 2, 32, 32, 4, 4, 16, "bias", True),
    "ring-segs-causal": ("ring", True, 2, 32, 32, 4, 4, 16, "segs", False),
    "ring-segs-full": ("ring", False, 2, 32, 32, 4, 4, 16, "segs", False),
    "uly-kv4-causal": ("uly", True, 2, 32, 32, 8, 4, 16, None, True),
    "uly-kv4-full": ("uly", False, 2, 32, 32, 8, 4, 16, None, False),
    "uly-kv4-bias": ("uly", True, 2, 32, 32, 8, 8, 16, "bias", True),
    "uly-kv4-segs": ("uly", True, 2, 32, 32, 4, 4, 16, "segs", False),
    "uly-kv2": ("uly", True, 2, 16, 16, 8, 2, 8, None, True),
    "uly-kv1": ("uly", True, 2, 16, 16, 8, 1, 8, None, False),
    "uly-ragged-6-24": ("uly", True, 2, 16, 16, 24, 6, 8, None, False),
    "uly-ragged-3-24": ("uly", True, 2, 16, 16, 24, 3, 8, None, True),
    "uly-ragged-6-36": ("uly", True, 2, 16, 16, 36, 6, 8, None, False),
    "uly-lcm": ("uly", True, 2, 16, 16, 12, 6, 8, None, False),
}
RAGGED = ("uly-ragged-6-24", "uly-ragged-3-24", "uly-ragged-6-36")


def _inputs(case: str) -> dict:
    _, _, B, Sq, Sk, H, KV, D, _, _ = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    cut = Sq // 2
    seg = np.concatenate([np.zeros((B, cut)), np.ones((B, Sq - cut))], 1)
    return {"q": rng.randn(B, Sq, H, D).astype(np.float32),
            "k": rng.randn(B, Sk, KV, D).astype(np.float32),
            "v": rng.randn(B, Sk, KV, D).astype(np.float32),
            "bias": rng.randn(H, Sq, Sk).astype(np.float32),
            "seg": seg.astype(np.int32)}


def _rank_case(attn, case: str, r: int, n: int) -> dict:
    _, causal, *_, extra, grads = CASES[case]
    x = _inputs(case)

    def chunk(a):
        s = a.shape[1] // n
        return torch.from_numpy(a).narrow(1, r * s, s)

    q, k, v = (chunk(x[name]).clone().requires_grad_()
               for name in ("q", "k", "v"))
    kw = {}
    if extra == "bias":
        kw["bias"] = chunk(x["bias"]).clone().requires_grad_()
    if extra == "segs":
        kw["segment_ids"] = chunk(x["seg"])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = attn(q, k, v, causal=causal, **kw)
    res = {"out": out.detach().numpy(),
           "warned": np.array(any("divide neither way" in str(w.message)
                                  for w in seen))}
    if grads:
        (out ** 2).sum().backward()
        res.update(dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
        if extra == "bias":
            res["dbias"] = kw["bias"].grad.numpy()
    return res


def _inbound_heads(mesh, case: str, r: int, n: int) -> list:
    """The head counts of the all-to-alls that gather the sequence."""
    import torchdistx_tpu_torch.parallel.ulysses as uly_mod

    seen = []
    real = uly_mod.all_to_all

    def spy(x, *a, **kw):
        seen.append(tuple(x.shape))
        return real(x, *a, **kw)

    uly_mod.all_to_all = spy
    try:
        _rank_case(uly_mod.make_ulysses_attention(mesh), case, r, n)
    finally:
        uly_mod.all_to_all = real
    s = CASES[case][3] // n
    return sorted(shape[2] for shape in seen if shape[1] == s)


def _checks(rank: int, world: int) -> dict:
    from torchdistx_tpu_torch.models.layers import default_attention
    from torchdistx_tpu_torch.ops import make_flash_attention
    from torchdistx_tpu_torch.parallel import (
        make_mesh,
        make_ring_attention,
        make_ring_flash_attention,
        make_ulysses_attention,
    )

    got = {"divide": False}
    uly = make_ulysses_attention(make_mesh({"sp": world}, device_type="cpu"))
    x = torch.ones(1, 2, 6, 4)  # 6 heads over sp 4
    try:
        uly(x, x, x)
    except ValueError as e:
        got["divide"] = "divide query heads" in str(e)
    mesh = make_mesh({"dp": world}, device_type="cpu")
    inner = make_flash_attention()
    got["degrade"] = (make_ulysses_attention(mesh) is default_attention
                      and make_ulysses_attention(mesh, inner_attn=inner)
                      is inner
                      and make_ring_attention(mesh) is default_attention
                      and make_ring_flash_attention(mesh)
                      is default_attention)
    return got


def _collectives(mesh, rank: int, world: int) -> dict:
    """Each collective's result (and the differentiable ones' gradients)
    on this rank, against what it should be."""
    from torchdistx_tpu_torch.parallel import collectives as c

    x = torch.arange(8.0).view(4, 2) + 10 * rank
    mine = [torch.arange(8.0).view(4, 2) + 10 * j for j in range(world)]
    prev, nxt = (rank - 1) % world, (rank + 1) % world
    got = {
        "size_index": (c.axis_size(mesh, "sp"), c.axis_index(mesh, "sp"))
        == (world, rank),
        "psum": torch.equal(c.psum(x, mesh, "sp"), sum(mine)),
        "reduce_scatter": torch.equal(c.reduce_scatter(x, mesh, "sp"),
                                      sum(mine)[rank:rank + 1]),
        "all_gather": torch.equal(c.all_gather(x, mesh, "sp", dim=1),
                                  torch.cat(mine, 1)),
        "all_to_all": torch.equal(
            c.all_to_all(x, mesh, "sp", split_dim=0, concat_dim=1),
            torch.cat([m[rank:rank + 1] for m in mine], 1)),
        "ring": (torch.equal(c.ppermute_next([x], mesh, "sp")[0], mine[prev])
                 and torch.equal(c.ppermute_prev([x], mesh, "sp")[0],
                                 mine[nxt])),
        "edges": (torch.equal(c.send_next([x], mesh, "sp")[0],
                              mine[prev] if rank else torch.zeros_like(x))
                  and torch.equal(c.send_prev([x], mesh, "sp")[0],
                                  mine[nxt] if rank < world - 1
                                  else torch.zeros_like(x))),
    }
    # The backward of each differentiable collective is its conjugate.
    g = x.clone().requires_grad_()
    (c.all_gather(g, mesh, "sp", dim=1) * torch.arange(2.0 * world)).sum() \
        .backward()
    got["all_gather_grad"] = torch.equal(
        g.grad, (world * torch.arange(2.0 * world))[2 * rank:2 * rank + 2]
        .expand(4, 2))
    g.grad = None
    y = c.all_to_all(g, mesh, "sp", split_dim=0, concat_dim=1)
    (y * y).sum().backward()
    got["all_to_all_grad"] = torch.equal(g.grad, 2 * x)
    g.grad = None
    (c.ppermute_next([g], mesh, "sp")[0] * (rank + 1)).sum().backward()
    got["ring_grad"] = torch.equal(g.grad,
                                   torch.full_like(x, float(nxt + 1)))
    return got


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    from torchdistx_tpu_torch.parallel import (
        make_mesh,
        make_ring_attention,
        make_ulysses_attention,
    )

    try:
        mesh = make_mesh({"sp": world}, device_type="cpu")
        fns = {"ring": make_ring_attention(mesh),
               "uly": make_ulysses_attention(mesh)}
        out = {}
        for case, spec in CASES.items():
            res = _rank_case(fns[spec[0]], case, rank, world)
            out.update({f"{case}/{k}": a for k, a in res.items()})
        for case in ("uly-kv2", "uly-ragged-3-24"):
            out[f"{case}/inbound"] = np.array(
                _inbound_heads(mesh, case, rank, world))
        out.update({f"checks/{k}": np.array(v)
                    for k, v in _checks(rank, world).items()})
        out.update({f"collectives/{k}": np.array(v) for k, v in
                    _collectives(mesh, rank, world).items()})
    finally:
        dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_ulysses")
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def _jax_fns():
    from torchdistx_tpu.parallel import make_mesh
    from torchdistx_tpu.parallel.ring_attention import make_ring_attention
    from torchdistx_tpu.parallel.ulysses import make_ulysses_attention

    mesh = make_mesh({"dp": 2, "sp": 4})
    return {"ring": make_ring_attention(mesh),
            "uly": make_ulysses_attention(mesh)}


def _jax_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    strategy, causal, *_, extra, grads = CASES[case]
    attn = _jax_fns()[strategy]
    x = {n: jnp.asarray(a) for n, a in _inputs(case).items()}

    def f(q, k, v, bias):
        kw = {}
        if extra == "bias":
            kw["bias"] = bias
        if extra == "segs":
            kw["segment_ids"] = x["seg"]
        out = attn(q, k, v, causal=causal, **kw)
        return (out ** 2).sum(), out

    args = (x["q"], x["k"], x["v"], x["bias"])
    if not grads:
        return {"out": np.asarray(jax.jit(f)(*args)[1])}
    (_, out), g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    res = {"out": np.asarray(out)}
    res.update({n: np.asarray(a) for n, a in zip(("dq", "dk", "dv"), g)})
    if extra == "bias":
        res["dbias"] = np.asarray(g[3])
    return res


def _check(ranks, case: str) -> None:
    for key, want in _jax_case(case).items():
        got = np.concatenate([r[f"{case}/{key}"] for r in ranks], 1)
        tol = FWD_TOL if key == "out" else GRAD_TOL
        err = float(np.abs(got - want).max())
        assert err < tol, f"{case} {key}: {err} >= {tol}"


@pytest.mark.parametrize("causal", ["causal", "full"])
def test_dense_ring_matches_jax(ranks, causal):
    """Self-attention, cross-attention of other lengths, the bias and
    packed ids through the dense ring."""
    for kind in ("self", "cross", "bias", "segs"):
        _check(ranks, f"ring-{kind}-{causal}")


@pytest.mark.parametrize("kv", ["kv4", "kv2", "kv1"])
def test_ulysses_matches_jax(ranks, kv):
    """KV % sp == 0 splits the kv heads (with the bias re-split by heads,
    the segment ids gathered and the gradients); sp % KV == 0 repeats
    each kv head to its group's slots."""
    for case in CASES:
        if case.startswith(f"uly-{kv}"):
            _check(ranks, case)


def test_ulysses_ragged_grouping(ranks):
    """KV and sp dividing neither way: gcd grouping, no warning; H ==
    lcm(sp, KV) warns that nothing moves less than the broadcast."""
    for case in RAGGED:
        _check(ranks, case)
        assert not any(bool(r[f"{case}/warned"]) for r in ranks), case
    _check(ranks, "uly-lcm")
    assert all(bool(r["uly-lcm/warned"]) for r in ranks)


def test_ulysses_moves_fewer_bytes(ranks):
    """The inbound all-to-alls carry q at H heads and k, v at sp slots
    (KV 2 < sp 4) or KV·sp slots (ragged KV 3, H 24), not H."""
    for r in ranks:
        assert list(r["uly-kv2/inbound"]) == sorted([8, 4, 4])
        assert list(r["uly-ragged-3-24/inbound"]) == sorted([24, 12, 12])


def test_collectives(ranks):
    """psum, reduce_scatter, all_gather, all_to_all, the ring shifts with
    and without wraparound over sp 4, and the gradients of the
    differentiable ones (their conjugate collectives)."""
    for r in ranks:
        bad = [k for k in r if k.startswith("collectives/") and not bool(r[k])]
        assert not bad, bad


def test_ulysses_checks(ranks):
    """A head count sp does not divide raises; without an sp axis each
    factory gives the plain attention (or Ulysses's inner one)."""
    for r in ranks:
        assert bool(r["checks/divide"]) and bool(r["checks/degrade"])
