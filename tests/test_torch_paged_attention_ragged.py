"""Paged decode against the JAX ``paged_attention`` (Pallas, interpret mode)
on ragged lengths, head groupings and page sizes.

Kept apart from ``test_torch_paged_attention.py`` so that neither file
holds more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the
files with the most tests first, and the JAX package's longest files
hold few (``test_rollover.py`` 9), so a slow port file of more than 9
would start before them and delay them.
"""

import pytest

from test_torch_paged_attention import _both, _check_against_jax, _np_case


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_ragged_matches_jax(dtype, atol, H, KV):
    B, D, page, maxp = 4, 16, 8, 3
    lengths = [1, page * maxp, 7, 13]
    q, kp, vp, table = _np_case(0, B=B, H=H, KV=KV, D=D, page=page,
                                n_pages=16, maxp=maxp)
    jx, tx = _both(q, kp, vp, lengths, table, dtype)
    _check_against_jax(jx, tx, lengths, atol)


@pytest.mark.parametrize("page", [4, 16])
def test_page_sizes_match_jax(page):
    B, H, KV, D, maxp = 3, 4, 2, 8, 4
    lengths = [page * maxp - 1, 2, page]
    q, kp, vp, table = _np_case(1, B=B, H=H, KV=KV, D=D, page=page,
                                n_pages=32, maxp=maxp)
    jx, tx = _both(q, kp, vp, lengths, table, "float32")
    _check_against_jax(jx, tx, lengths, 1e-5)
