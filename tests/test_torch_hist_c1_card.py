"""K1 on the card: the CUDA kernel against its plain PyTorch version,
bit for bit, at the main path's segment widths.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker
and skip without a card.  This file imports no jax (the card's machine
has none); run it there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_hist_c1_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.ops import hist_c1 as k1
from mp3tpu_torch.ops import loop


def random_batch(seed, G):
    """Random quantized batches (the mix of tests/test_pallas_bits.py):
    silent, tiny, mid, ESC-range and out-of-range granules with zero
    tails and count1 runs; ~30% short blocks, ~10% start/stop."""
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1.5, 8.0, 40.0, 600.0, 9000.0], size=(G, 1))
    ix = np.abs(rng.randn(G, 576) * scale).astype(np.int32)
    for g in range(G):
        cut = rng.randint(0, 577)
        ix[g, cut:] = 0
        tail = rng.randint(0, cut + 1)
        ix[g, tail:cut] = rng.randint(0, 2, size=cut - tail)
    is_short = rng.rand(G) < 0.3
    wsf = is_short | (rng.rand(G) < 0.1)
    return ix, is_short, wsf


def kernel_args(ix, is_short, wsf, device, version=mpeg.MPEG1):
    """hist_c1's arguments for a batch, with run lengths and region
    addresses from the port's own counting at 44.1 kHz (MPEG-1) or
    22.05 kHz (MPEG-2 LSF, whose short-block region-0 boundary
    differs)."""
    ST = loop.device_tables(loop.static_tables(version, 0), device)
    ixt = torch.as_tensor(ix, device=device)
    sh = torch.as_tensor(is_short, device=device)
    count1, bv = loop.calc_runlen(ixt, sh)
    _, _, a1, a2 = loop.subdivide(bv, sh, torch.as_tensor(wsf, device=device),
                                  ST)
    return ixt, a1, a2, bv, count1, sh, ST["r0_pairs_short"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [512, 4096, 4099])
def test_kernel_matches_plain_on_card(card, G):
    args = kernel_args(*random_batch(G, G), card)
    before = k1.hist_c1.launches
    got = k1.hist_c1(*args)
    torch.cuda.synchronize()
    assert k1.hist_c1.launches == before + 1
    want = k1.hist_c1_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_lsf(card):
    batch = random_batch(22050, 4096)
    args = kernel_args(*batch, card, mpeg.MPEG2_LSF)
    # the LSF long-block sfb table moves the region addresses a1, a2
    assert not torch.equal(args[1], kernel_args(*batch, card)[1])
    got = k1.hist_c1(*args)
    torch.cuda.synchronize()
    want = k1.hist_c1_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    ixt, a1, a2, bv, c1, sh, r0 = kernel_args(*random_batch(1, 64), card)
    with pytest.raises(TypeError):
        k1.hist_c1(ixt.to(torch.int64), a1, a2, bv, c1, sh, r0)
    with pytest.raises(ValueError):
        k1.hist_c1(ixt[:, ::2].contiguous(), a1, a2, bv, c1, sh, r0)
    with pytest.raises(ValueError):
        k1.hist_c1(ixt.t().contiguous().t(), a1, a2, bv, c1, sh, r0)
