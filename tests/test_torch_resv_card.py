"""K4, the reservoir scan in one launch (``csrc/resv_scan.cu``), on the
card: equal to its plain version, the native host scan that
``ops/resv.py`` runs for a CPU tensor, on every budget and every carried
level -- one clip with padded holes, ``resv_max == 0``, LSF, an odd
``mean_bits``, several tiles; batches of 1 to 32 clips with distinct
levels; a valid row a clip -- with no wait on the host and no host scan;
and the wrapper refuses what the kernel does not take, with no fall back
to the host.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker and
skip without a card (tests/test_torch_resv_model.py holds the kernel's
design to the JAX scan on the CPU).  This file imports no jax; run it on
the card without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_resv_card.py
"""
import contextlib

import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import resv

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def no_wait():
    """Raise on any operation that makes the host wait for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def scan_inputs(seed, B, F, R):
    """Random pe (B, F, R) float32 (a fifth of it 0) and demand (B, F, R)
    int32 (a twentieth 0)."""
    rng = np.random.RandomState(seed)
    pe = rng.uniform(0, 3000, (B, F, R)).astype(np.float32)
    pe[rng.rand(B, F, R) < 0.2] = 0.0
    demand = rng.randint(0, 4096, (B, F, R)).astype(np.int32)
    demand[rng.rand(B, F, R) < 0.05] = 0
    return pe, demand


#: seed, frames, nch, mode_gr, mean_bits, resv_max, delta, size0, valid
ONE_CLIP = [
    (0, 200, 2, 2, 3080, 4088, 28, 0, "all"),
    (1, 150, 1, 2, 1460, 4088, 28, 512, "tail"),
    (2, 128, 2, 2, 3081, 4088, 12, 1024, "tail"),
    (3, 100, 2, 2, 3080, 4088, 0, 200, "holes"),
    (4, 60, 2, 2, 3080, 0, 28, 0, "tail"),
    (5, 1024, 2, 2, 3344, 4088, 28, 2000, "holes"),
    (6, 2500, 1, 1, 1080, 2040, 28, 96, "holes"),
    (7, 300, 2, 1, 1331, 2040, 28, 8, "tail"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,F,nch,mode_gr,mean_bits,resv_max,delta,"
                         "size0,valid", ONE_CLIP,
                         ids=[f"case{c[0]}-{c[-1]}" for c in ONE_CLIP])
def test_k4_equals_the_host_scan(card, seed, F, nch, mode_gr, mean_bits,
                                 resv_max, delta, size0, valid):
    pe, demand = scan_inputs(seed, 1, F, mode_gr * nch)
    rng = np.random.RandomState(seed + 100)
    vf = {"all": np.ones(F, bool), "tail": np.arange(F) < F - 23,
          "holes": rng.rand(F) < 0.8}[valid]
    args = (mean_bits, resv_max, mode_gr, nch, delta)
    want_b, want_s = resv.scan_budgets(torch.as_tensor(pe[0]),
                                       torch.as_tensor(demand[0]), size0,
                                       *args, valid=torch.as_tensor(vf))
    pe_d, dem_d = torch.as_tensor(pe[0], device=card), \
        torch.as_tensor(demand[0], device=card)
    vf_d = torch.as_tensor(vf, device=card)
    size_d = torch.tensor(size0, dtype=torch.int32, device=card)
    resv.build()
    k0, h0 = resv.launches, resv.host_scans
    with no_wait():
        got_b, got_s = resv.scan_budgets(pe_d, dem_d, size_d, *args,
                                         valid=vf_d)
        # a Python level is filled in on the card, not uploaded
        again_b, again_s = resv.scan_budgets(pe_d, dem_d, size0, *args,
                                             valid=vf_d)
    assert (resv.launches - k0, resv.host_scans - h0) == (2, 0)
    assert got_b.is_cuda and got_s.is_cuda
    assert got_b.dtype == got_s.dtype == torch.int32 and got_s.dim() == 0
    assert torch.equal(got_b.cpu(), want_b) and torch.equal(again_b, got_b)
    assert int(got_s) == int(again_s) == int(want_s)


#: B, frames, nch, mode_gr, mean_bits, resv_max: a corpus group of 16 at
#: 10 s, 32 clips, LSF, resv_max 0
BATCHED = [
    (1, 431, 2, 2, 3344, 4088),
    (3, 200, 2, 2, 3081, 4088),
    (16, 431, 2, 2, 3344, 4088),
    (32, 431, 2, 2, 3344, 4088),
    (3, 120, 1, 1, 1080, 2040),
    (5, 90, 2, 2, 3080, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,nch,mode_gr,mean_bits,resv_max", BATCHED,
                         ids=[f"B{c[0]}-F{c[1]}-nch{c[2]}-gr{c[3]}-"
                              f"mb{c[4]}-max{c[5]}" for c in BATCHED])
def test_k4_batched_equals_the_host_scans(card, B, F, nch, mode_gr,
                                          mean_bits, resv_max):
    """One launch for B clips with distinct levels == B host scans."""
    pe, demand = scan_inputs(B * 1000 + F, B, F, mode_gr * nch)
    rng = np.random.RandomState(B)
    size0 = (rng.randint(0, max(resv_max, 8) + 1, B) // 8 * 8) \
        .astype(np.int32)
    args = (mean_bits, resv_max, mode_gr, nch, 28)
    want_b, want_s = resv.scan_budgets_batched(
        torch.as_tensor(pe), torch.as_tensor(demand), torch.as_tensor(size0),
        *args)
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, size0)]
    resv.build()
    k0 = resv.launches
    with no_wait():
        got_b, got_s = resv.scan_budgets_batched(*ins, *args)
    assert resv.launches - k0 == 1
    assert torch.equal(got_b.cpu(), want_b)
    assert torch.equal(got_s.cpu(), want_s)


@pytest.mark.cuda
def test_k4_with_a_valid_row_a_clip(card):
    """(B, F) flags: each clip's padded frames leave its own level."""
    B, F, nch, mode_gr = 4, 300, 2, 2
    pe, demand = scan_inputs(21, B, F, nch * mode_gr)
    valid = np.random.RandomState(22).rand(B, F) < 0.7
    size0 = np.array([0, 800, 4000, 96], np.int32)
    args = (3081, 4088, mode_gr, nch, 28)
    got_b, got_s = resv._launch(
        *[torch.as_tensor(a, device=card) for a in (pe, demand, valid,
                                                     size0)], *args)
    for b in range(B):
        want_b, want_s = resv.scan_budgets(
            torch.as_tensor(pe[b]), torch.as_tensor(demand[b]),
            int(size0[b]), *args, valid=torch.as_tensor(valid[b]))
        assert torch.equal(got_b[b].cpu(), want_b), b
        assert int(got_s[b]) == int(want_s), b


@pytest.mark.cuda
def test_k4_refuses_and_never_falls_back(card):
    """A float64 pe, or a valid row left on the host, raises; no host
    scan runs."""
    pe, demand = scan_inputs(3, 1, 16, 4)
    args = (3080, 4088, 2, 2, 28)
    h0 = resv.host_scans
    pe_d = torch.as_tensor(pe[0], device=card)
    dem_d = torch.as_tensor(demand[0], device=card)
    with pytest.raises(TypeError):
        resv.scan_budgets(pe_d.double(), dem_d, 0, *args)
    with pytest.raises(ValueError):
        resv.scan_budgets(pe_d, dem_d, 0, *args,
                          valid=torch.ones(16, dtype=torch.bool))
    assert resv.host_scans == h0
