"""The port's host INIT metadata against the JAX package's, byte for byte.

``repro_torch.core.metadata`` is a copy of ``repro.core.metadata``; every
table it bakes must equal the reference's in dtype, shape and bytes, and a
``PatternSignature`` digest must not depend on how the dtype is spelled, in
either package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metadata as jax_md
from repro_torch.core import metadata as md
from repro_torch.testing.patterns import (banded_counts, hugetrace_like_counts,
                                          random_counts)

PATTERNS = {
    "dense": lambda p: np.full((p, p), 5, np.int64),
    "banded": lambda p: banded_counts(p),
    "skewed": lambda p: random_counts(p, seed=p, max_count=20),
    "hugetrace": lambda p: hugetrace_like_counts(
        p, 8, hot_ranks=sorted({r % p for r in (5, 6, 7)})),
}


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_tables_byte_equal(pattern, p):
    c = PATTERNS[pattern](p)
    for fn in ("recv_counts", "displacements", "put_displacements"):
        assert_same(getattr(md, fn)(c), getattr(jax_md, fn)(c), fn)
    cap = md.global_capacity(c)
    assert cap == jax_md.global_capacity(c)
    for fn in ("ring_round_capacities", "xor_round_capacities"):
        mine, ref = getattr(md, fn)(c), getattr(jax_md, fn)(c)
        assert_same(mine, ref, fn)
        assert_same(md.active_round_schedule(mine),
                    jax_md.active_round_schedule(ref), "active_round_schedule")
    recv_rows = max(md.round_up(md.max_total_recv(c), 8), 8)
    mine = md.baked_index_tables(c, cap, recv_rows)
    ref = jax_md.baked_index_tables(c, cap, recv_rows)
    for f in dataclasses.fields(ref):
        assert_same(getattr(mine, f.name), getattr(ref, f.name), f.name)

    p_outer = 2
    mine = md.hier_two_stage_schedule(c, p_outer, p // p_outer, recv_rows)
    ref = jax_md.hier_two_stage_schedule(c, p_outer, p // p_outer, recv_rows)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert_same(a, b, f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("names", [
    ("float32", torch.float32, np.float32, jnp.float32),
    ("float16", torch.float16, np.float16, jnp.float16),
    ("bfloat16", torch.bfloat16, "bfloat16", jnp.bfloat16),
], ids=lambda n: n[0])
def test_signature_digest_ignores_dtype_spelling(names):
    c = random_counts(4)
    kw = dict(feature_shape=(8,), variant="lock", axis=("x",), row_bytes=32,
              lock_schedule="pairwise", pack_impl="pallas", axis_sizes=(4,))
    digests = {md.PatternSignature.build(c, dtype=d, **kw).digest
               for d in names[1:3]}
    ref = jax_md.PatternSignature.build(c, dtype=names[3], **kw)
    assert digests == {ref.digest}
    assert md.PatternSignature.build(c, dtype=names[1], **kw).dtype == names[0]
