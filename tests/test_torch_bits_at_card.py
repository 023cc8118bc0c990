"""bits_at on the card: the CUDA kernel against its plain PyTorch chain,
equal on every output, at the main path's segment widths.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker
and skip without a card.  This file imports no jax (the card's machine
has none); run it there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_bits_at_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop
from mp3tpu_torch.tables import mpeg


def random_batch(seed, G):
    """Random permuted |xr|^0.75 batches and stepsizes: silent, tiny, mid,
    ESC-range and out-of-range granules (about a quarter exceed IXMAX)
    with zero tails and runs of values <= 1; ~30% short blocks, ~10%
    start/stop."""
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1.0, 3.0, 20.0, 300.0, 5000.0, 1e5],
                       size=(G, 1))
    xr = np.abs(rng.randn(G, 576) * scale)
    for g in range(G):
        cut = rng.randint(0, 577)
        xr[g, cut:] = 0
        tail = rng.randint(0, cut + 1)
        xr[g, tail:cut] = rng.rand(cut - tail) * 1.6
    xr75 = (xr ** 0.75).astype(np.float32)
    qss = rng.randint(-60, 20, size=G).astype(np.float32)
    is_short = rng.rand(G) < 0.3
    wsf = is_short | (rng.rand(G) < 0.1)
    return xr75, qss, is_short, wsf


def kernel_args(xr75, qss, is_short, wsf, device, version=mpeg.MPEG1):
    """bits_at's arguments for a batch, with the tables of 44.1 kHz
    (MPEG-1) or 22.05 kHz (MPEG-2 LSF)."""
    ST = loop.device_tables(loop.static_tables(version, 0), device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(xr75), t(qss), t(is_short), t(wsf), ST


def mismatches(got, want):
    """The output names where two bits_at results differ in dtype, shape
    or any value."""
    return [k for k in want
            if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            or not torch.equal(got[k], want[k])]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [512, 4096, 4099])
def test_kernel_matches_plain_on_card(card, G):
    args = kernel_args(*random_batch(G, G), card)
    before = K.bits_at.launches
    got = K.bits_at(*args)
    torch.cuda.synchronize()
    assert K.bits_at.launches == before + 1
    want = K.bits_at_plain(*args)
    assert not mismatches(got, want)
    over = (want["ix_max"] > loop.IXMAX).sum().item()
    assert 0 < over < G


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_lsf(card):
    batch = random_batch(22050, 4096)
    args = kernel_args(*batch, card, mpeg.MPEG2_LSF)
    got = K.bits_at(*args)
    torch.cuda.synchronize()
    want = K.bits_at_plain(*args)
    assert not mismatches(got, want)
    # the LSF long-block sfb table moves the region addresses
    mpeg1 = K.bits_at_plain(*kernel_args(*batch, card))
    assert not torch.equal(want["a1"], mpeg1["a1"])


@pytest.mark.cuda
def test_kernel_matches_plain_over_range(card):
    """Every granule past IXMAX: bits 1e9, counts still exact."""
    xr75, qss, is_short, wsf = random_batch(7, 1024)
    xr75[:, 0] = 1e6
    args = kernel_args(xr75, np.full_like(qss, -40.0), is_short, wsf, card)
    got = K.bits_at(*args)
    torch.cuda.synchronize()
    want = K.bits_at_plain(*args)
    assert not mismatches(got, want)
    assert bool((want["bits"] == 1e9).all())


@pytest.mark.cuda
def test_loop_bits_at_launches_the_kernel(card):
    args = kernel_args(*random_batch(3, 256), card)
    before = K.bits_at.launches
    bits, c = loop._bits_at(*args)
    assert K.bits_at.launches == before + 1
    assert bits is c["bits"]
