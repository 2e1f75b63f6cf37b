"""The keyed, counter-based draws (``ops/keyed_rng.py``): the plain
version's Philox4x32-10 against a scalar one written here and against
Random123's known answers, a region of the full shape equal to its slice
of the whole draw (hypothesis over shapes and regions), the uniform
formula bit for bit, the moments of both kinds, the wrapper's refusals,
and, on the card only, the CUDA kernel against the plain version.

No JAX here: the file holds a test that runs on the card, whose machine
has no JAX."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torchdistx_tpu_torch.ops import keyed_rng

torch.set_num_threads(2)

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def scalar_philox(ctr, key):
    """Philox4x32-10 as Random123 defines it, on Python ints."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK]
        k = [(k[0] + W0) & MASK, (k[1] + W1) & MASK]
    return c


# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                0x24126EA1)),
]


def test_plain_philox_against_the_known_answers_and_a_scalar_philox():
    for ctr, key, out in KNOWN:
        assert tuple(scalar_philox(ctr, key)) == out
    words = keyed_rng.philox4x32(torch.tensor([0]), 0)
    assert tuple(int(w) for w in words) == KNOWN[0][2]
    rng = np.random.RandomState(0)
    blocks = rng.randint(0, 2 ** 62, 64, dtype=np.int64)
    blocks[:3] = [0, MASK, MASK + 1]
    for key in (0, 1, 0xDEADBEEFCAFEF00D, 2 ** 64 - 1):
        got = keyed_rng.philox4x32(torch.from_numpy(blocks), key)
        for j, b in enumerate(blocks.tolist()):
            want = scalar_philox((b & MASK, b >> 32, 0, 0),
                                 (key & MASK, key >> 32))
            assert [int(w[j]) for w in got] == want, (key, b)


def test_uniform_is_the_formula_bit_for_bit():
    """Element g takes lane g % 4 of block g // 4: u = (lane >> 8) 2^-24,
    lo + f32(hi - lo) * u, each step rounded to f32."""
    key, lo, hi = 0x1234_5678_9ABC_DEF0, -0.9544997361036416, 0.9544997361036416
    got = keyed_rng.keyed_draw_reference((3, 7), torch.float32, "uniform",
                                         lo, hi, key)
    span = np.float32(np.float32(hi) - np.float32(lo))
    for g, v in enumerate(got.reshape(-1).tolist()):
        lane = scalar_philox((g // 4, 0, 0, 0), (key & MASK, key >> 32))[g % 4]
        u = np.float32((lane >> 8) * 2.0 ** -24)
        assert np.float32(v) == np.float32(np.float32(lo) + np.float32(span * u))


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_a_region_equals_its_slice_of_the_full_draw(data):
    ndim = data.draw(st.integers(1, 4))
    full = [data.draw(st.integers(1, 9)) for _ in range(ndim)]
    start = [data.draw(st.integers(0, f - 1)) for f in full]
    shape = [data.draw(st.integers(1, f - s)) for f, s in zip(full, start)]
    kind = data.draw(st.sampled_from(["uniform", "normal"]))
    dtype = data.draw(st.sampled_from(list(keyed_rng.DTYPES)))
    key = data.draw(st.integers(0, 2 ** 64 - 1))
    whole = keyed_rng.keyed_draw_reference(full, dtype, kind, -1.5, 2.5, key)
    part = torch.empty(shape, dtype=dtype)
    before = keyed_rng.launches
    keyed_rng.keyed_fill_(part, kind, -1.5, 2.5, key, full, start)
    want = whole[tuple(slice(s, s + n) for s, n in zip(start, shape))]
    assert torch.equal(part, want)
    assert keyed_rng.launches == before  # CPU tensors never launch


@pytest.mark.parametrize("kind,a,b", [("uniform", -2.0, 3.0),
                                      ("normal", 0.5, 0.02)])
def test_moments(kind, a, b):
    n = 1 << 18
    x = keyed_rng.keyed_draw_reference((n,), torch.float32, kind, a, b,
                                       key=99).double()
    if kind == "uniform":
        mean, std = (a + b) / 2, (b - a) / math.sqrt(12)
        assert float(x.min()) >= a and float(x.max()) < b
    else:
        mean, std = a, b
    assert abs(float(x.mean()) - mean) < 5 * std / math.sqrt(n)
    assert abs(float(x.std()) / std - 1) < 0.01
    if kind == "normal":  # the tails of a normal, not of a uniform
        z = (x - mean) / std
        assert abs(float((z.abs() > 2).double().mean()) - 0.0455) < 0.003
        assert abs(float((z ** 4).mean()) - 3) < 0.1


def test_dtypes_round_the_f32_draw_once_and_refusals():
    f32 = keyed_rng.keyed_draw_reference((5, 6), torch.float32, "normal",
                                         0.0, 1.0, 7)
    for dt in (torch.bfloat16, torch.float16):
        got = keyed_rng.keyed_draw_reference((5, 6), dt, "normal", 0.0, 1.0, 7)
        assert torch.equal(got, f32.to(dt))
    # A non-contiguous target is drawn contiguous and copied in.
    t = torch.zeros(6, 5).t()
    keyed_rng.keyed_fill_(t, "normal", 0.0, 1.0, 7)
    assert torch.equal(t, f32)
    with pytest.raises(TypeError, match="keyed draws fill"):
        keyed_rng.keyed_fill_(torch.zeros(3, dtype=torch.float64), "normal",
                              0.0, 1.0, 7)
    with pytest.raises(ValueError, match="outside the full shape"):
        keyed_rng.keyed_fill_(torch.zeros(3), "uniform", 0.0, 1.0, 7, (4,),
                              (2,))
    with pytest.raises(ValueError, match="kind"):
        keyed_rng.keyed_fill_(torch.zeros(3), "gumbel", 0.0, 1.0, 7)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version on the card: uniform bit
    for bit, normal within 2 ulp of the dtype, in f32, bf16 and f16; a
    region bit for bit its slice of the full draw."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    full, start, shape = (6, 130, 257), (2, 3, 5), (3, 100, 250)
    for dtype in keyed_rng.DTYPES:
        for kind, a, b in (("uniform", -0.95, 0.95), ("normal", 0.0, 0.02)):
            out = torch.empty(full, dtype=dtype, device=dev)
            before = keyed_rng.launches
            keyed_rng.keyed_fill_(out, kind, a, b, 12345)
            assert keyed_rng.launches == before + 1
            plain = keyed_rng.keyed_draw_reference(full, dtype, kind, a, b,
                                                   12345, device=dev)
            if kind == "uniform":
                assert torch.equal(out, plain)
            else:
                # One ulp of the plain value in ``dtype``: 2**(e - 1) * eps
                # for |x| in [2**(e - 1), 2**e).
                _, e = torch.frexp(plain.float())
                ulp = torch.ldexp(torch.full_like(plain, torch.finfo(
                    dtype).eps, dtype=torch.float32), e - 1)
                assert bool(((out.float() - plain.float()).abs()
                             <= 2 * ulp).all())
            part = torch.empty(shape, dtype=dtype, device=dev)
            keyed_rng.keyed_fill_(part, kind, a, b, 12345, full, start)
            assert torch.equal(part, out[2:5, 3:103, 5:255])
