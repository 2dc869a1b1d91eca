"""The three hand CUDA kernels against their plain torch versions.

The tests marked `cuda` run only where torch sees a GPU (nvcc builds the
kernels at first use); elsewhere they skip with a reason. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The unmarked tests check, on any host, what surrounds the kernels: the
CPU route of each wrapper, the build naming and the sources.
"""
import os

import numpy as np
import pytest
import torch

from desamba_tpu_torch import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index
    from desamba_tpu_torch.convert import build_tables

    return build_tables(from_oracle_index(golden_oracle_index), "cpu")


def _to(tabs, dev):
    from desamba_tpu_torch.ops.fm import FmArrays

    fm = tabs[0]
    return FmArrays(fm.occ32.to(dev), fm.pad.to(dev), fm.rank.to(dev),
                    fm.hash13.to(dev), fm.sa_uni.to(dev), fm.sa_off.to(dev),
                    fm.lfc.to(dev), fm.L, fm.dollar_pos)


def _search_inputs(fm, n, W, seed):
    """n lanes over random reads of width W, seeded from hash13 of each
    read's 13-mer ending at a random position, plus odd lanes (ptr out of
    range, empty intervals)."""
    rng = np.random.default_rng(seed)
    B2 = max(1, n // 7)
    codes = rng.integers(0, 4, (B2, W)).astype(np.int32)
    lane = rng.integers(0, B2, n).astype(np.int32)
    s_idx = rng.integers(13, W + 3, n).astype(np.int32)
    pre = np.zeros(n, np.int64)
    for t in range(13):
        pre = (pre << 2) | codes[lane, np.clip(s_idx - 12 + t, 0, W - 1)]
    hash13 = fm.hash13.cpu().numpy()
    sp0 = hash13[pre].astype(np.int32)
    ep0 = hash13[pre + 1].astype(np.int32)
    k = min(3, n)
    sp0[:k] = [0, 5, int(fm.L) - 1][:k]
    ep0[:k] = [0, 40, int(fm.L) + 1][:k]
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return dict(codes=i32(codes), lane=i32(lane), s_idx=i32(s_idx),
                sp0=i32(sp0), ep0=i32(ep0),
                max_rst=i32(np.full(n, 2)),
                l_min=i32(rng.choice([14, 20], n)),
                l_max=i32(np.minimum(s_idx, rng.choice([16, 41], n))))


# --------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("n,W,steps", [(1, 256, 4096), (1000, 300, 2),
                                       (4099, 1024, 8), (777, 2048, 28)])
def test_interval_search_kernel(cuda, tables, n, W, steps):
    from desamba_tpu_torch.ops.fm import (interval_search_plain,
                                          interval_search_state, iv_init)

    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, n, W, n).items()}
    st = iv_init(d["sp0"], d["ep0"], d["s_idx"])
    args = (fm, d["codes"], d["lane"], d["max_rst"], d["l_min"], d["l_max"])
    before = kernels.launches["interval_search"]
    for k in range(2):  # fresh, then resumed from the kernel's carry
        got = interval_search_state(*args, st, steps)
        ref = interval_search_plain(*args, st, steps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        st = got
    assert kernels.launches["interval_search"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,W,cap", [(1, 256, 12), (999, 300, 16),
                                     (5003, 2048, 60)])
def test_row_walks_kernel(cuda, tables, n, W, cap):
    from desamba_tpu_torch.ops.fm import (interval_search_state, iv_init,
                                          row_walks_plain, row_walks_state,
                                          rw_init)

    fm = _to(tables, cuda)
    d = {k: v.to(cuda) for k, v in _search_inputs(fm, n, W, n + 1).items()}
    st = interval_search_state(fm, d["codes"], d["lane"], d["max_rst"],
                               d["l_min"], d["l_max"],
                               iv_init(d["sp0"], d["ep0"], d["s_idx"]), 28)
    rows = st[2].clone()
    k = min(2, n)
    rows[:k] = torch.tensor([-3, fm.lfc.shape[0] + 5][:k], dtype=torch.int32)
    mlen = torch.clamp(d["s_idx"] - st[4], min=0).to(torch.int32)
    state = rw_init(rows, st[5])
    for k in range(2):
        got = row_walks_state(fm, d["codes"], d["lane"], mlen, state, cap)
        ref = row_walks_plain(fm, d["codes"], d["lane"], mlen, state, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        state = got


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,K", [(1, 256, 16), (7, 512, 80),
                                   (33, 2048, 144), (130, 3072, 208)])
def test_band_score_kernel(cuda, B, W, K):
    from desamba_tpu_torch.ops.matchblock import (band_score_packed,
                                                  band_score_packed_plain)

    rng = np.random.default_rng(B)
    NW = W // 16 + K // 16 + 1
    read = rng.integers(0, 4, (B, W))
    win = rng.integers(0, 4, (B, 16 * NW))
    for b in range(B):
        for _ in range(6):
            k, q, ln = (int(rng.integers(0, K)), int(rng.integers(0, W - 40)),
                        int(rng.integers(4, 40)))
            win[b, q + k : q + k + ln] = read[b, q : q + ln]
    pack = lambda c: torch.from_numpy((c.reshape(c.shape[0], -1, 16).astype(
        np.uint64) << (2 * np.arange(16, dtype=np.uint64))).sum(2).astype(
        np.uint32).view(np.int32))
    rlen = rng.integers(1, W + 1, B).astype(np.int32)
    lo = rng.integers(-100, 60, B).astype(np.int32)
    hi = rng.integers(16 * NW - 60, 16 * NW + 100, B).astype(np.int32)
    if B > 1:
        lo[1], hi[1] = 200, 200
    args = [pack(read), torch.from_numpy(rlen), pack(win),
            torch.from_numpy(lo), torch.from_numpy(hi)]
    args = [a.to(cuda) for a in args]
    got = band_score_packed(*args, K)
    ref = band_score_packed_plain(*args, K)
    torch.cuda.synchronize()
    for f in ("score", "q_st", "q_ed"):
        assert torch.equal(got[f], ref[f]), f
    assert int(got["score"].max()) > 0


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    from desamba_tpu_torch.ops.matchblock import band_score_packed

    rw = torch.zeros((4, 16), dtype=torch.int64, device=cuda)
    z = torch.zeros(4, dtype=torch.int32, device=cuda)
    ww = torch.zeros((4, 16 + 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        band_score_packed(rw, z, ww, z, z, 16)
    strided = torch.zeros((4, 36), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        band_score_packed(rw.to(torch.int32), z, strided, z, z, 16)
    with pytest.raises(ValueError):
        band_score_packed(rw.to(torch.int32), z.cpu(), ww, z, z, 16)


# ------------------------------------------------------------ any host --
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    from desamba_tpu_torch.ops.matchblock import band_score_packed

    before = dict(kernels.launches)
    rw = torch.zeros((2, 16), dtype=torch.int32)
    ww = torch.zeros((2, 16 + 2), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    out = band_score_packed(rw, z + 256, ww, z, z + 300, 16)
    assert out["score"].tolist() == [248, 248]
    assert kernels.launches == before


def test_devices_other_than_cpu_and_cuda_are_refused():
    assert kernels.launch_device(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        kernels.launch_device(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_sources_and_build_names(name):
    src = kernels.source_path(name)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, src)).read()
    entry = kernels.KERNELS[name][1]
    assert f'extern "C" int {entry}(' in text
    assert "cudaGetLastError()" in text
    path = kernels._lib_path(kernels.KERNELS[name][0])
    assert path == kernels._lib_path(kernels.KERNELS[name][0])
    assert path.startswith(kernels.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
