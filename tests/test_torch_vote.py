"""Stage 3's vote (ops/vote) against the JAX package's stage 3, on the
CPU: stage-2 outputs built by test_torch_kernels.vote_cases on the golden
index (each case asserted reached) go through JAX's stage 3 and the
port's, with the plain ops and with the default ops (on the CPU, the
vote wrapper runs vote_plain). Everything is integer, so every
comparison is exact equality. The test marked `cuda` holds the vote
kernel to vote_plain on the card at every width bucket:

    python -m pytest tests/test_torch_vote.py -m cuda -q

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the cuda and tables fixtures are test_torch_kernels'
from test_torch_kernels import cuda, tables  # noqa: F401
from test_torch_kernels import check_vote_coverage, vote_cases, vote_nwR
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

# the width buckets up to the classifier's default max_width (8192)
WIDTHS = (256, 512, 1024, 2048, 3072, 4096, 5120, 6144, 7168, 8192)


@pytest.fixture(scope="module")
def jax_tables(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index
    from desamba_tpu.ops.fm import FmArrays
    from desamba_tpu.ops.locate import LocArrays

    ti = from_oracle_index(golden_oracle_index)
    return FmArrays(ti), LocArrays(ti)


def test_vote_nwR_is_stage1s_window_grid(tables):
    """vote_nwR equals the anchor lanes a row that stage 1's output shape
    gives (kidx's windows times ROWS_PER_SEARCH) at every width bucket,
    on the golden exist filter (lek 16)."""
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR, ROWS_PER_SEARCH
    from desamba_tpu_torch.ops.seeds import stage1_plain

    ek = tables[1]
    assert ek.lek == 16
    for W in WIDTHS:
        kidx = stage1_plain(ek.w01, torch.zeros((1, W), dtype=torch.uint8),
                            torch.tensor([W], dtype=torch.int32), ek.lek,
                            ek.single_base_max, ek.mask_bits, ek.n_words0)[1]
        assert vote_nwR(W, ek.lek) == kidx.shape[1] * ROWS_PER_SEARCH, W
    assert [vote_nwR(W, 16) * REFPOS_PER_ANCHOR for W in WIDTHS] == [
        24, 40, 88, 168, 248, 336, 416, 496, 584, 664]


@pytest.mark.parametrize("ops", ["plain", "default"])
@pytest.mark.parametrize("W,B2", [(256, 40), (2048, 40), (4096, 40),
                                  (8192, 40), (3072, 37)])
def test_stage3_equals_jax_on_vote_cases(tables, jax_tables, W, B2, ops):
    """The port's stage 3 (locate, then vote) with PLAIN_OPS or the
    default ops on the CPU equals JAX's stage 3 element for element on
    vote_cases, each case asserted reached."""
    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR
    from desamba_tpu_torch.engine import fast_engine as tfe
    from desamba_tpu_torch.ops.locate import locate_plain

    fm, ek, loc, _ = tables
    *s2, lengths2, nwR, groups = vote_cases(fm, loc, W, ek.lek, B2)
    check_vote_coverage(*locate_plain(fm, loc, s2[0], s2[1],
                                      REFPOS_PER_ANCHOR),
                        *s2[2:], lengths2, B2, nwR, groups)
    js3 = jax.jit(_build_stages(ek.lek, ek.single_base_max, ek.mask_bits,
                                20, ek.n_words0)[2],
                  static_argnames=("B2", "nwR"))
    ref = js3(*jax_tables, jnp.asarray(lengths2.numpy()),
              *(jnp.asarray(t.numpy()) for t in s2), B2=B2, nwR=nwR)
    s3 = tfe.build_stages(ek.lek, ek.single_base_max, ek.mask_bits, 20,
                          ek.n_words0,
                          ops=tfe.PLAIN_OPS if ops == "plain"
                          else tfe.KERNEL_OPS)[2]
    got = s3(fm, loc, lengths2, *s2, B2=B2, nwR=nwR)
    for name, a, b in zip(("ref_c", "diag_c", "vote_c"), ref, got,
                          strict=True):
        a = np.asarray(a)
        assert b.dtype == torch.int32 and b.shape == (B2, 3), name
        assert (a == b.numpy()).all(), (name, int((a != b.numpy()).sum()))


def test_vote_cpu_route_and_input_checks(tables):
    """On CPU tensors the wrapper runs vote_plain and counts no launch;
    it refuses inputs of another dtype, shape or device, and P or nwR
    below 1."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR
    from desamba_tpu_torch.ops.locate import locate_plain
    from desamba_tpu_torch.ops.vote import vote, vote_plain

    fm, ek, loc, _ = tables
    *s2, lengths2, nwR, _ = vote_cases(fm, loc, 256, ek.lek, 24)
    args = [*locate_plain(fm, loc, s2[0], s2[1], REFPOS_PER_ANCHOR), *s2[2:],
            lengths2]
    before = dict(kernels.launches)
    got = vote(*args, 24, nwR)
    assert kernels.launches == before
    for a, b in zip(got, vote_plain(*args, 24, nwR), strict=True):
        assert torch.equal(a, b)
    for i, bad in ((0, args[0].to(torch.int64)), (2, args[2].to(torch.int32)),
                   (3, args[3][:-1]), (5, args[5].to(torch.int64)),
                   (6, args[6][:-1]), (1, args[1].t()),
                   (4, args[4].to("meta"))):
        with pytest.raises(ValueError):
            vote(*args[:i], bad, *args[i + 1:], 24, nwR)
    with pytest.raises(ValueError):
        vote(*args, 23, nwR)  # lengths2 is not [B2]
    with pytest.raises(ValueError):
        vote(*args, 24, 0)
    with pytest.raises(ValueError):
        vote(*args, 24, 2 ** 29)


@pytest.mark.cuda
@pytest.mark.parametrize("W", WIDTHS)
def test_vote_kernel_on_vote_cases(cuda, tables, W):
    """The vote kernel equals vote_plain on vote_cases at every width
    bucket up to W = 8192 (A = 24 ... 664 slots a row), and counts one
    launch a call."""
    from desamba_tpu_torch import kernels
    from desamba_tpu_torch.constants import REFPOS_PER_ANCHOR
    from desamba_tpu_torch.ops.locate import locate_plain
    from desamba_tpu_torch.ops.vote import vote, vote_plain

    fm, ek, loc, _ = tables
    *s2, lengths2, nwR, _ = vote_cases(fm, loc, W, ek.lek, 53)
    args = [t.to(cuda) for t in (
        *locate_plain(fm, loc, s2[0], s2[1], REFPOS_PER_ANCHOR), *s2[2:],
        lengths2)]
    n = kernels.launches["vote"]
    got = vote(*args, 53, nwR)
    assert kernels.launches["vote"] == n + 1
    ref = vote_plain(*args, 53, nwR)
    torch.cuda.synchronize()
    for a, b in zip(got, ref, strict=True):
        assert torch.equal(a, b)
