"""The port's stage 0 (unpack) and stage 4 (band windows, band score,
combine) against the JAX package's, on the CPU: the same inputs, made with
numpy from a seed on the golden reference, go through the JAX functions
and the port's plain versions (PLAIN_OPS). Everything is integer, so every
comparison is exact equality.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import (_combine_inputs, check_stage4_coverage,
                                stage4_cases, wire_batch)
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401


@pytest.fixture(scope="module")
def jax_ra(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index
    from desamba_tpu.ops.refwin import RefArrays

    return RefArrays(from_oracle_index(golden_oracle_index))


@pytest.fixture(scope="module")
def host_ra(golden_index_dir):
    from desamba_tpu_torch.index.loader import load_index
    from desamba_tpu_torch.ops.refwin import RefArrays

    return RefArrays.from_tensor_index(load_index(golden_index_dir))


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), (
        what, int((a != b).sum()))


@pytest.mark.parametrize("W", [256, 1024, 2048, 3072])
def test_unpack_plain_equals_jax(W):
    """unpack_plain == JAX stage0_unpack, its codes as int32 and
    _read_words (as uint32 bits) on random wire rows with padding rows."""
    from desamba_tpu.engine.fast_engine import _read_words, stage0_unpack
    from desamba_tpu_torch.ops.unpack import unpack_plain

    packed, lens = wire_batch(40, W, seed=W)
    codes2, l2 = stage0_unpack(jnp.asarray(packed), jnp.asarray(lens))
    ref = (codes2, codes2.astype(jnp.int32), _read_words(jnp.asarray(packed)),
           l2)
    got = unpack_plain(torch.from_numpy(packed), torch.from_numpy(lens))
    assert [g.dtype for g in got] == [torch.uint8] + [torch.int32] * 3
    for i, (a, b) in enumerate(zip(ref, got, strict=True)):
        b = b.numpy()
        _eq(a, b.view(np.uint32) if i == 2 else b, f"unpack[{i}]")
    # padding rows (length 0) are decoded too, forward and rc halves
    pad = np.flatnonzero(lens == 0)
    assert pad.size >= 2 and got[0][pad].any() and got[0][pad + 40].any()


@pytest.mark.parametrize("W", [256, 2048])
def test_stage4_plain_ops_equal_jax_on_edge_cases(W, jax_ra, host_ra):
    """Stage 4 with PLAIN_OPS == JAX stage 4 on the golden reference, on
    candidates built to reach each case (stage4_cases): ties of odd and
    even scores across refs on both strands, rows of -1 candidates,
    diagonals at the int32 ends, refs 0, n_ref - 1, past n_ref and -1."""
    from desamba_tpu.engine.fast_engine import (_build_stages, _read_words,
                                                stage0_unpack)
    from desamba_tpu_torch.constants import PACK_KEYS, _band
    from desamba_tpu_torch.engine import fast_engine as tfe

    packed, lens, ref_c, diag_c, groups = stage4_cases(host_ra, W)
    K = 2 * _band(W) + 16
    B2 = ref_c.shape[0]
    vote_c = np.random.default_rng(W).integers(0, 99, ref_c.shape).astype(
        np.int32)  # stage 4 reads no votes
    # stage 4 reads none of the exist-filter parameters
    js4 = jax.jit(_build_stages(16, 12, 20, 20)[3],
                  static_argnames=("B2", "K"))
    _, jl2 = stage0_unpack(jnp.asarray(packed), jnp.asarray(lens))
    ref = js4(jax_ra, _read_words(jnp.asarray(packed)), jl2,
              jnp.asarray(ref_c), jnp.asarray(diag_c), jnp.asarray(vote_c),
              B2=B2, K=K)
    ts4 = tfe.build_stages(16, 12, 20, 20, ops=tfe.PLAIN_OPS)[3]
    _, _, rw, l2 = tfe.PLAIN_OPS["unpack"](torch.from_numpy(packed),
                                           torch.from_numpy(lens))
    got = ts4(host_ra, rw, l2, torch.from_numpy(ref_c),
              torch.from_numpy(diag_c), torch.from_numpy(vote_c), B2=B2, K=K)
    assert list(got) == list(PACK_KEYS) and set(ref) == set(PACK_KEYS)
    for k in PACK_KEYS:
        _eq(ref[k], got[k], f"stage4[{k}]")
    check_stage4_coverage(host_ra, packed, lens, ref_c, diag_c, groups, K)
    # rows without a hit: ref -1, and the tie order takes candidate 0
    inv = groups["all_invalid"]
    assert (got["ref"][inv] == -1).all() and (got["direction"][inv] == 1).all()


@pytest.mark.parametrize("B,C,n_ref", [(77, 3, 3), (4096, 3, 89), (300, 5, 4)])
def test_combine_plain_equals_jax_combine(B, C, n_ref, monkeypatch):
    """combine_plain == the fold and pick of JAX's stage 4, run with its
    band scorer replaced by the same scores, on random candidates whose
    q_st, q_ed, diagonals and ref offsets span all of int32 (_combine_inputs,
    as the card's combine tests use): pos of the chosen candidate wraps,
    and ties of odd and even scores fall across refs."""
    import desamba_tpu.ops.matchblock as jmb
    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu.ops.refwin import RefArrays as JaxRefArrays
    from desamba_tpu_torch.constants import PACK_KEYS
    from desamba_tpu_torch.ops.rescore import combine_plain

    ra, score, q_st, q_ed, ref_c, diag_c = _combine_inputs(
        B, C, n_ref, B + C, "cpu")
    j = lambda t: jnp.asarray(t.numpy())
    bs = dict(score=j(score), q_st=j(q_st), q_ed=j(q_ed))
    monkeypatch.setattr(jmb, "band_score_packed", lambda *a, K: bs)
    jra = JaxRefArrays(_from=((None, None, j(ra.ref_words_lsb),
                               j(ra.ref_offset), j(ra.ref_len)), ()))
    B2 = 2 * B
    ref = _build_stages(16, 12, 20, 20)[3](
        jra, jnp.zeros((B2, 16), jnp.uint32), jnp.zeros(B2, jnp.int32),
        j(ref_c), j(diag_c), None, B2=B2, K=80)
    got = combine_plain(ra, score, q_st, q_ed, ref_c, diag_c)
    assert got.dtype == torch.int32 and got.shape == (6, B)
    for i, k in enumerate(PACK_KEYS):
        _eq(ref[k], got[i], f"combine[{k}]")
    # the inputs reach the wrap: rows whose every candidate on the chosen
    # ref at the best score has its pos outside int32
    fold = lambda x: np.concatenate([x[:B], x[B:]], 1).astype(np.int64)
    s4, r2 = fold(score.numpy().reshape(B2, C)), fold(ref_c.numpy())
    s4 = np.where(r2 >= 0, s4, -1)
    qs = fold(q_st.numpy().reshape(B2, C))
    d2 = fold(diag_c.numpy())
    off = ra.ref_offset.numpy().astype(np.int64)
    ref_b = got[1].numpy()[:, None]
    chosen = (s4 == s4.max(1, keepdims=True)) & (r2 == ref_b) & (ref_b >= 0)
    pos = d2 + qs - off[np.clip(ref_b, 0, n_ref - 1)]
    in32 = (pos >= -2**31) & (pos < 2**31)
    assert (chosen.any(1) & ~(chosen & in32).any(1)).any()
    s_max = s4.max(1)
    for parity in (0, 1):  # ties across refs at odd and at even scores
        at = (s4 == s_max[:, None]) & (r2 >= 0)
        tie = np.array([len(set(r2[b, at[b]])) > 1 for b in range(B)])
        assert (tie & (s_max > 0) & (s_max % 2 == parity)).any()
