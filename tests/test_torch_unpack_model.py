"""Stage 0's unpack kernel (K10, csrc/unpack.cu) in its formulation: a
numpy model of the kernel's index map. A warp takes a tile of 128
consecutive words of 16 codes (flat over the output rows) in a
grid-stride loop over the tiles; a lane loads its 4 words with one
16-byte load where they lie in one row, 16-byte aligned, else byte by
byte (the ragged edge, or packed at any byte offset; it loads the warp's next tile's before storing,
which the model does not order), stores them to read_w2 as one piece,
stages the
tile's 512 wire bytes, then store k of codes2 has lane i expand word
32k + i and store k of codes_i byte 32k + i, so that consecutive lanes
write consecutive 16-byte pieces; lengths2 is written by a grid-stride
loop over the threads. The model counts the writes to every output
element.

Held to unpack_plain and to JAX's stage0_unpack, its int32 cast and
_read_words, element for element (integers: exact equality), with every
element written exactly once and every store a whole aligned 16-byte
piece, at Bp = 1, odd Bp, W = 16, 48, 2048, 3072 and 8192, on a grid of
the card's size (132 SMs x 4 blocks) and on grids of a few blocks
(several tiles a warp, several lengths a thread), with the 16-byte
loads and without.

The module imports no JAX at top level: the card's tests below reuse
the cases. On the card:

    python -m pytest tests/test_torch_unpack_model.py -m cuda -q

Change the kernel and the model together.
"""
import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels
from desamba_tpu_torch.ops.unpack import unpack, unpack_plain
from test_torch_kernels import wire_batch

WARPS = 8  # warps a block (unpack.cu kWarps)
THREADS = 32 * WARPS
TILE = 128  # words a warp's tile (kTileWords)
H100_BLOCKS = 132 * 4  # a grid of the card's size: 132 SMs x kMinBlocks

# (Bp, W, blocks the card holds): Bp = 1 and odd, W down to one word a
# row and ragged (W/16 = 3), the path's widths, a grid of one block
# (every warp strides over many tiles, every thread over many lengths)
CASES = [(1, 16, H100_BLOCKS), (1, 2048, H100_BLOCKS), (3, 48, H100_BLOCKS),
         (7, 3072, H100_BLOCKS), (5, 8192, H100_BLOCKS),
         (33, 3072, H100_BLOCKS), (300, 16, 1), (13, 48, 2), (9, 2048, 3),
         (4, 8192, 1)]


def grid(Bp: int, W: int, most: int) -> tuple[int, int]:
    """(blocks, tiles) of dsb_unpack: enough blocks for every tile and for
    the 2 Bp lengths, at most the `most` that the card holds at once."""
    n_words = 2 * Bp * (W // 16)
    n_tiles = -(-n_words // TILE)
    blocks = max(-(-n_tiles // WARPS), -(-2 * Bp // THREADS))
    return min(blocks, most), n_tiles


def spread(words: np.ndarray) -> np.ndarray:
    """uint8[n, 16]: the 16 codes of each little-endian word, code 0 at
    bits 0-1 of byte 0."""
    b = words.astype("<u4").view(np.uint8).reshape(-1, 4)
    return np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], 2).reshape(-1, 16)


def unpack_model(packed: np.ndarray, lens: np.ndarray,
                 most: int = H100_BLOCKS, aligned: bool = True,
                 stats: dict | None = None):
    """csrc/unpack.cu on packed uint8[Bp, W/2] and lens int32[Bp]: (codes2
    uint8[2Bp, W], codes_i int32[2Bp, W], read_w2 int32[2Bp, W/16],
    lengths2 int32[2Bp]), by the kernel's index map on a grid of
    grid(Bp, W, most) blocks. aligned: the pointers are 16-byte aligned
    (the kernel then takes the 16-byte loads where W % 64 == 0). Asserts
    that every output element is written exactly once and that every
    vector store is a whole 16-byte piece at a 16-byte aligned offset.
    stats counts the tiles ("tiles"), the tiles of a warp's later strides
    ("strided"), the 16-byte loads ("wide") and the words loaded
    byte by byte ("words")."""
    Bp, Wq2 = packed.shape
    W = 2 * Wq2
    Wq = W // 16
    n_words = 2 * Bp * Wq
    wire = packed.reshape(-1)
    blocks, n_tiles = grid(Bp, W, most)
    vec = Wq % 4 == 0 and aligned
    codes2 = np.zeros(n_words * 16, np.uint8)
    codes_i = np.zeros(n_words * 16, np.int32)
    read_w2 = np.zeros(n_words, np.uint32)
    lengths2 = np.zeros(2 * Bp, np.int32)
    hits = {k: np.zeros(v.size, np.int64)
            for k, v in (("codes2", codes2), ("codes_i", codes_i),
                         ("read_w2", read_w2), ("lengths2", lengths2))}
    st = stats if stats is not None else {}
    for k in ("tiles", "strided", "wide", "words"):
        st.setdefault(k, 0)

    def wire_offset(g):
        """byte offset of flat word g's wire bytes (unpack.cu wire_word)"""
        r, w = g // Wq, g % Wq
        return (r % Bp) * (8 * Wq) + (r // Bp) * (4 * Wq) + 4 * w

    def wire_words(g):
        off = wire_offset(g)[:, None] + np.arange(4)
        return wire[off].reshape(-1).view("<u4")

    # lengths2: thread j of the grid, striding by the grid's threads
    for j0 in range(0, 2 * Bp, blocks * THREADS):
        j = np.arange(j0, min(2 * Bp, j0 + blocks * THREADS))
        lengths2[j] = lens[np.where(j < Bp, j, j - Bp)]
        np.add.at(hits["lengths2"], j, 1)
    lanes = np.arange(32)
    for warp in range(blocks * WARPS):  # block warp // WARPS, warp % WARPS
        for t in range(warp, n_tiles, blocks * WARPS):
            st["tiles"] += 1
            st["strided"] += t != warp
            base = t * TILE
            g0 = base + 4 * lanes
            stage = np.zeros((32, 4), np.uint32)
            if vec:
                on = g0 < n_words
                off = wire_offset(g0[on])
                # the lane's 4 words lie in one row, 16 wire bytes in a row
                # at a 16-byte aligned offset: one 16-byte load
                assert (g0[on] // Wq == (g0[on] + 3) // Wq).all()
                assert (off % 16 == 0).all()
                assert (wire_offset(g0[on] + 3) == off + 12).all()
                st["wide"] += int(on.sum())
                v = wire[off[:, None] + np.arange(16)].reshape(-1)
                stage[on] = v.view("<u4").reshape(-1, 4)
                # read_w2: lane i's piece at word g0, 16-byte aligned
                assert (g0[on] % 4 == 0).all()
                idx = (g0[on][:, None] + np.arange(4)).reshape(-1)
                read_w2[idx] = stage[on].reshape(-1)
                np.add.at(hits["read_w2"], idx, 1)
            else:
                for k in range(4):
                    on = g0 + k < n_words
                    st["words"] += int(on.sum())
                    stage[on, k] = wire_words(g0[on] + k)
                    read_w2[g0[on] + k] = stage[on, k]
                    np.add.at(hits["read_w2"], g0[on] + k, 1)
            sw = stage.reshape(-1)  # the tile's 128 words in shared memory
            sb = sw.astype("<u4").view(np.uint8)  # and its 512 bytes
            for k in range(4):  # codes2: word m = 32k + lane
                m = 32 * k + lanes
                on = base + m < n_words
                dst = 16 * (base + m[on])
                assert (dst % 16 == 0).all()
                idx = (dst[:, None] + np.arange(16)).reshape(-1)
                codes2[idx] = spread(sw[m[on]]).reshape(-1)
                np.add.at(hits["codes2"], idx, 1)
            for k in range(16):  # codes_i: byte b = 32k + lane, 4 codes
                b = 32 * k + lanes
                on = base + b // 4 < n_words
                dst = 16 * base + 4 * b[on]  # int32 elements
                assert (dst % 4 == 0).all()  # 16-byte aligned
                x = sb[b[on]].astype(np.int32)
                idx = (dst[:, None] + np.arange(4)).reshape(-1)
                codes_i[idx] = np.stack([(x >> s) & 3 for s in (0, 2, 4, 6)],
                                        1).reshape(-1)
                np.add.at(hits["codes_i"], idx, 1)
    for name, h in hits.items():
        assert (h == 1).all(), (name, int((h == 0).sum()),
                                int((h > 1).sum()))
    rows = 2 * Bp
    return (codes2.reshape(rows, W), codes_i.reshape(rows, W),
            read_w2.view(np.int32).reshape(rows, Wq), lengths2)


@pytest.mark.parametrize("Bp,W,most", CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_unpack_model_equals_plain_and_jax(Bp, W, most, aligned):
    """The model == unpack_plain == JAX's stage 0 (with _build_full's
    int32 cast and _read_words), every element written once."""
    import jax.numpy as jnp

    from desamba_tpu.engine.fast_engine import _read_words, stage0_unpack

    packed, lens = wire_batch(Bp, W, seed=Bp * W + most)
    stats: dict = {}
    got = unpack_model(packed, lens, most, aligned, stats)
    plain = unpack_plain(torch.from_numpy(packed), torch.from_numpy(lens))
    codes2, l2 = stage0_unpack(jnp.asarray(packed), jnp.asarray(lens))
    jax_out = (np.asarray(codes2), np.asarray(codes2.astype(jnp.int32)),
               np.asarray(_read_words(jnp.asarray(packed))).view(np.int32),
               np.asarray(l2))
    for i, (g, p, j) in enumerate(zip(got, plain, jax_out, strict=True)):
        assert g.dtype == p.numpy().dtype == j.dtype, i
        assert (g == p.numpy()).all() and (g == j).all(), i
    n_tiles = grid(Bp, W, most)[1]
    assert stats["tiles"] == n_tiles
    # the routes each case is meant to reach
    wide = aligned and (W // 16) % 4 == 0
    assert (stats["wide"] > 0) == wide and (stats["words"] > 0) != wide
    assert (stats["strided"] > 0) == (n_tiles > grid(Bp, W, most)[0] * WARPS)


def test_unpack_cases_reach_the_edges():
    """CASES reach a ragged last tile, tiles that cross rows, a grid too
    small for the tiles and one too small for the lengths."""
    ragged = cross = tiles = lengths = False
    for Bp, W, most in CASES:
        n_words = 2 * Bp * (W // 16)
        blocks, n_tiles = grid(Bp, W, most)
        ragged |= n_words % TILE != 0
        cross |= (W // 16) % TILE != 0 and n_words > TILE
        tiles |= n_tiles > blocks * WARPS
        lengths |= 2 * Bp > blocks * THREADS
    assert ragged and cross and tiles and lengths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Bp,W", sorted({(b, w) for b, w, _ in CASES}))
@pytest.mark.parametrize("offset", [0, 8, 1])
def test_unpack_kernel_model_cases(cuda, Bp, W, offset):
    """The kernel == unpack_plain on CASES' shapes, one launch a call;
    offset > 0: packed starts that many bytes into its buffer (8: 16-byte
    loads refused; 1: no wire word 4-byte aligned), so the kernel takes
    its byte loads."""
    packed, lens = wire_batch(Bp, W, seed=Bp * W)
    p = torch.from_numpy(packed).to(cuda)
    if offset:
        buf = torch.empty(p.numel() + offset, dtype=torch.uint8,
                          device=cuda)
        p = buf[offset:].view(p.shape).copy_(p)
        assert p.data_ptr() % 16 == offset
    ln = torch.from_numpy(lens).to(cuda)
    before = kernels.launches["unpack"]
    got = unpack(p, ln)
    ref = unpack_plain(p, ln)
    torch.cuda.synchronize()
    assert kernels.launches["unpack"] == before + 1
    for name, g, r in zip(("codes2", "codes_i", "read_w2", "lengths2"), got,
                          ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r), name
