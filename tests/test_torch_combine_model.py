"""Stage 4's combine (K9b, combine_kernel in csrc/rescore.cu) in its
formulation: a numpy model of the kernel. A block takes COMBINE_READS
reads b0 .. b0 + nb - 1 (one thread each) and, in one round of
asynchronous copies, stages into shared memory, for each of score, q_st,
q_ed, ref_c and diag_c, the forward span [b0*C, (b0+nb)*C) and the
reverse-complement span [(B+b0)*C, (B+b0+nb)*C), each in its own slot of
COMBINE_READS*C words (16-byte copies where B*C is a multiple of 4 and
every array is 16-byte aligned, else 4-byte ones; the tail of a span
past its last 16-byte piece in 4-byte copies), and, up to
COMBINE_REFS_STAGED refs, the whole ref_offset table. Then each thread
picks its read's best candidate from shared memory alone: the masked
scores, the odd/even tie order (cly.c:62), the first candidate of the
chosen ref, cov, pos (int32 wrap) and the best other-ref score; only
above COMBINE_REFS_STAGED refs does it read ref_offset at the chosen ref
from device memory. The path's C = 3 runs a variant whose loops unroll;
every other C (up to COMBINE_MAX_C) the generic one. The model counts
every shared word copied (once each, none read before it is copied) and
every output element written (once each).

Held to combine_plain and to JAX's stage-4 combine (its band scorer
monkeypatched to the given scores), element for element, on
`combine_model_cases`: planted rows with ties at odd and even s_max,
s_max of -1 and 0, candidates with ref -1, refs past n_ref (the clamp),
pos that wraps int32, the pick on either strand and another ref's score
for score_alt, then random rows; C = 1, 3 and 5; B with a ragged last
block; both copy widths; n_ref at and above the staging cap.
`check_combine_coverage` asserts each case reached.

The module imports no JAX at top level: the card's tests below reuse the
cases. On the card:

    python -m pytest tests/test_torch_combine_model.py -m cuda -q

Change the kernel and the model together.
"""
import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.rescore import (COMBINE_MAX_C, COMBINE_READS,
                                           COMBINE_REFS_STAGED, combine,
                                           combine_plain)
from test_torch_kernels import I32_MAX, I32_MIN, _combine_inputs, cuda  # noqa: F401

I32 = np.int32


def _wrap(x):
    """int64 values as int32 arithmetic wraps them."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int64)


def combine_model(score, q_st, q_ed, ref_c, diag_c, ref_offset,
                  aligned: bool = True):
    """The kernel's output int32[6, B] and the routes it took ({"vec",
    "staged", "variant", "ragged"}). score, q_st, q_ed: int32[2B*C];
    ref_c, diag_c: int32[2B, C]; ref_offset: int32[n_ref]; aligned:
    whether every candidate array starts on a 16-byte boundary."""
    B2, C = ref_c.shape
    B, n_ref, T = B2 // 2, len(ref_offset), COMBINE_READS
    assert 1 <= C <= COMBINE_MAX_C and B2 % 2 == 0 and n_ref >= 1
    vec = aligned and (B * C) % 4 == 0
    staged = n_ref <= COMBINE_REFS_STAGED
    fields = [np.asarray(a, np.int64).reshape(-1)
              for a in (score, q_st, q_ed, ref_c, diag_c)]
    offs = np.asarray(ref_offset, np.int64)
    out = np.zeros((6, B), np.int64)
    writes = np.zeros((6, B), np.int64)
    span = T * C
    for b0 in range(0, B, T):
        nb = min(T, B - b0)
        sm = np.zeros(10 * span + (n_ref if staged else 0), np.int64)
        copied = np.zeros(sm.shape, np.int64)

        def stage(dst, src, n, vector):
            # stage_words: thread t copies pieces t, t + T, ... of 16
            # bytes, then words 4*n4 + t, ... of 4 (all 4-byte without
            # vector)
            n4 = n // 4 if vector else 0
            for t in range(T):
                for p in range(t, n4, T):
                    assert (dst + 4 * p) % 4 == 0 and (src[1] + 4 * p) % 4 == 0
                    sm[dst + 4 * p:dst + 4 * p + 4] = src[0][
                        src[1] + 4 * p:src[1] + 4 * p + 4]
                    copied[dst + 4 * p:dst + 4 * p + 4] += 1
                for i in range(4 * n4 + t, n, T):
                    sm[dst + i] = src[0][src[1] + i]
                    copied[dst + i] += 1

        for f in range(5):
            for st in range(2):
                stage((2 * f + st) * span,
                      (fields[f], (st * B + b0) * C), nb * C, vec)
        if staged:
            stage(10 * span, (offs, 0), n_ref, False)
        assert copied.max() <= 1

        def at(f, t, k):
            i = (2 * f + (k >= C)) * span + t * C + k % C
            assert copied[i] == 1, "read before it was staged"
            return sm[i]

        for t in range(nb):
            n = 2 * C
            ref = [at(3, t, k) for k in range(n)]
            s4 = [at(0, t, k) if ref[k] >= 0 else -1 for k in range(n)]
            s_max = max(s4)
            tied = [ref[k] for k in range(n) if s4[k] == s_max]
            r_best = max(tied + [-1]) if s_max & 1 else min(tied + [n_ref + 1])
            cb = next((k for k in range(n)
                       if s4[k] == s_max and ref[k] == r_best), 0)
            ref_b = ref[cb] if s_max > 0 else -1
            rc = min(max(ref_b, 0), n_ref - 1)
            if staged:
                assert copied[10 * span + rc] == 1
                off = sm[10 * span + rc]
            else:
                off = offs[rc]  # the one global load at the pick
            qs = at(1, t, cb)
            pos = _wrap(_wrap(at(4, t, cb) + qs) - off)
            alt = max([s4[k] for k in range(n)
                       if ref[k] != ref_b and ref[k] >= 0] + [-1])
            b = b0 + t
            out[:, b] = (max(s_max, 0), ref_b, 0 if cb >= C else 1,
                         max(_wrap(at(2, t, cb) - qs), 0),
                         pos if ref_b >= 0 else -1, max(alt, 0))
            writes[:, b] += 1
    assert (writes == 1).all()
    return out.astype(I32), dict(vec=vec, staged=staged,
                                 variant="unrolled" if C == 3 else "generic",
                                 ragged=B % T != 0)


# (B, C, n_ref, aligned): the path's shape, ragged blocks with 4-byte
# copies, the generic variant, C = 1 above the staging cap, and ref
# tables at the cap and past it with misaligned arrays
MODEL_SHAPES = [
    (4096, 3, 89, True),
    (77, 3, 3, True),
    (300, 5, 4, True),
    (64, 1, 2000, True),
    (128, 3, COMBINE_REFS_STAGED, True),
    (33, 3, COMBINE_REFS_STAGED + 1, False),
]


def combine_model_cases(B, C, n_ref, seed=0):
    """(RefArrays, score, q_st, q_ed, ref_c, diag_c) on the CPU:
    _combine_inputs' random rows (scores in 0..6, refs in [-1, n_ref + 1],
    a tenth of q_st, q_ed and diag over all of int32), with the first
    reads planted:
      0  an odd tie between refs 1 and 2 (forward and rc): the higher
      1  an even tie between refs 1 and 2: the lower
      2  every ref -1: s_max = -1
      3  every score 0 with refs: s_max = 0, no call
      4  the best on ref n_ref + 1: the clamped ref_offset
      5  the best on the rc strand, another ref below it (score_alt),
         its pos past INT32_MAX (wraps)
      6  the same ref at the top on both strands: the forward one"""
    ra, score, q_st, q_ed, ref_c, diag_c = _combine_inputs(
        B, C, n_ref, seed, "cpu")
    s = score.numpy().reshape(2 * B, C)
    qs = q_st.numpy().reshape(2 * B, C)
    r, d = ref_c.numpy(), diag_c.numpy()
    off = ra.ref_offset.numpy()
    r1, r2 = min(1, n_ref - 1), min(2, n_ref - 1)

    def row(b, fwd, rc):
        """fwd, rc: [(ref, score)] of candidate 0 (and 1) a strand;
        the rest -1."""
        for strand, cands in ((b, fwd), (B + b, rc)):
            r[strand] = -1
            s[strand] = 0
            for c, (rr, ss) in enumerate(cands[:C]):
                r[strand, c], s[strand, c] = rr, ss

    plant = [
        lambda b: row(b, [(r1, 5)], [(r2, 5)]),
        lambda b: row(b, [(r1, 4)], [(r2, 4)]),
        lambda b: row(b, [], []),
        lambda b: row(b, [(r1, 0)], [(r2, 0)]),
        lambda b: row(b, [(n_ref + 1, 6)], [(r1, 2)]),
        lambda b: row(b, [(r1, 3)], [(r2, 6)]),
        lambda b: row(b, [(r2, 5)], [(r2, 5)]),
    ]
    for b, f in enumerate(plant[:B]):
        f(b)
    if B > 5:  # read 5's pick: rc candidate 0 on ref r2, pos wraps
        d[B + 5, 0] = I32_MAX - 3
        qs[B + 5, 0] = 100
        off[r2] = -50
    t = torch.from_numpy
    return (ra, t(s.reshape(-1).copy()), t(qs.reshape(-1).copy()), q_ed,
            t(r.copy()), t(d.copy()))


def check_combine_coverage(args, out):
    """Each planted case (and the routes of the model) reached on these
    inputs and outputs."""
    ra, score, q_st, q_ed, ref_c, diag_c = args
    B2, C = ref_c.shape
    B, n_ref = B2 // 2, ra.ref_offset.numel()
    fold = lambda x: np.concatenate(  # noqa: E731
        [x[:B], x[B:]], 1).astype(np.int64)
    r2 = fold(ref_c.numpy())
    s4 = np.where(r2 >= 0, fold(score.numpy().reshape(B2, C)), -1)
    s_max = s4.max(1)
    hit = set()
    at = s4 == s_max[:, None]
    for b in range(B):
        tied = set(r2[b, at[b]].tolist())
        if s_max[b] > 0 and len(tied) > 1:
            hit.add("odd tie" if s_max[b] & 1 else "even tie")
    hit |= {"s_max -1"} if (s_max == -1).any() else set()
    hit |= {"s_max 0"} if (s_max == 0).any() else set()
    hit |= {"ref -1"} if (r2 < 0).any() else set()
    o = out.numpy().astype(np.int64)
    hit |= {"ref past n_ref"} if (o[1] >= n_ref).any() else set()
    hit |= {"rc pick"} if ((o[2] == 0) & (o[1] >= 0)).any() else set()
    hit |= {"fwd pick"} if ((o[2] == 1) & (o[1] >= 0)).any() else set()
    hit |= {"score_alt"} if (o[5] > 0).any() else set()
    qs = fold(q_st.numpy().reshape(B2, C))
    d2 = fold(diag_c.numpy())
    offs = ra.ref_offset.numpy().astype(np.int64)
    cb = np.array([next(k for k in range(2 * C) if at[b, k]
                        and r2[b, k] == o[1, b]) if o[1, b] >= 0 else 0
                   for b in range(B)])
    raw = (d2[np.arange(B), cb] + qs[np.arange(B), cb]
           - offs[np.clip(o[1], 0, n_ref - 1)])
    if ((o[1] >= 0) & ((raw < I32_MIN) | (raw > I32_MAX))).any():
        hit.add("pos wraps")
    want = {"odd tie", "even tie", "s_max -1", "s_max 0", "ref -1",
            "ref past n_ref", "rc pick", "fwd pick", "score_alt",
            "pos wraps"}
    assert hit >= want, want - hit


def _jax_combine(args):
    """JAX's stage 4 (_build_stages) with its band scorer replaced by the
    given scores: the fold and pick alone, int32[6, B]."""
    import jax.numpy as jnp

    import desamba_tpu.ops.matchblock as jmb
    from desamba_tpu.engine.fast_engine import _build_stages
    from desamba_tpu.ops.refwin import RefArrays as JaxRefArrays
    from desamba_tpu_torch.constants import PACK_KEYS

    ra, score, q_st, q_ed, ref_c, diag_c = args
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    bs = dict(score=j(score), q_st=j(q_st), q_ed=j(q_ed))
    saved = jmb.band_score_packed
    jmb.band_score_packed = lambda *a, K: bs
    try:
        jra = JaxRefArrays(_from=((None, None, j(ra.ref_words_lsb),
                                   j(ra.ref_offset), j(ra.ref_len)), ()))
        B2 = ref_c.shape[0]
        ref = _build_stages(16, 12, 20, 20)[3](
            jra, jnp.zeros((B2, 16), jnp.uint32), jnp.zeros(B2, jnp.int32),
            j(ref_c), j(diag_c), None, B2=B2, K=80)
    finally:
        jmb.band_score_packed = saved
    return np.stack([np.asarray(ref[k]) for k in PACK_KEYS])


@pytest.mark.parametrize("B,C,n_ref,aligned", MODEL_SHAPES)
def test_combine_model_equals_jax_and_plain(B, C, n_ref, aligned):
    args = combine_model_cases(B, C, n_ref, seed=B + C)
    got, route = combine_model(*(a.numpy() for a in args[1:]),
                               args[0].ref_offset.numpy(), aligned=aligned)
    plain = combine_plain(*args)
    check_combine_coverage(args, plain)
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(got, _jax_combine(args))
    assert route == dict(vec=aligned and (B * C) % 4 == 0,
                         staged=n_ref <= COMBINE_REFS_STAGED,
                         variant="unrolled" if C == 3 else "generic",
                         ragged=B % COMBINE_READS != 0)


def test_combine_model_shapes_reach_every_route():
    routes = set()
    for B, C, n_ref, aligned in MODEL_SHAPES:
        routes |= {("vec", aligned and (B * C) % 4 == 0),
                   ("staged", n_ref <= COMBINE_REFS_STAGED),
                   ("unrolled", C == 3),
                   ("ragged", B % COMBINE_READS != 0)}
    assert routes == {(k, v) for k in ("vec", "staged", "unrolled", "ragged")
                      for v in (False, True)}


def test_combine_refuses_too_many_candidates():
    """Above COMBINE_MAX_C candidates a row the wrapper raises on the CPU
    as on the card (a block's staged candidates fill 48 KB of shared
    memory at COMBINE_MAX_C)."""
    args = combine_model_cases(4, COMBINE_MAX_C + 1, 3)
    with pytest.raises(ValueError):
        combine(*args)
    args = combine_model_cases(4, COMBINE_MAX_C, 3)
    assert torch.equal(combine(*args), combine_plain(*args))


def _misaligned(t, dev):
    """t's values on dev in a tensor that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,n_ref,aligned", MODEL_SHAPES)
def test_combine_kernel_model_cases(cuda, B, C, n_ref, aligned):
    """The kernel against combine_plain on the model's cases: both copy
    widths (aligned and 4 bytes off), both C variants, the staged and
    the global ref_offset."""
    from desamba_tpu_torch.ops.refwin import RefArrays

    args = combine_model_cases(B, C, n_ref, seed=B + C)
    ra = args[0]
    ra_d = RefArrays(ra.ref_words_lsb.to(cuda), ra.ref_offset.to(cuda),
                     ra.ref_len.to(cuda))
    put = (lambda t: t.to(cuda)) if aligned else (
        lambda t: _misaligned(t, cuda))
    dev_args = (ra_d, *(put(t) for t in args[1:]))
    before = kernels.launches["combine"]
    got = combine(*dev_args)
    torch.cuda.synchronize()
    assert kernels.launches["combine"] == before + 1
    assert torch.equal(got.cpu(), combine_plain(*args))
