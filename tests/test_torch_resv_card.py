"""K4, the reservoir scan (``csrc/resv_scan.cu``: the chunk maps, then
their composition and the re-walk, one call), on the card: equal to its
plain version, the native host scan that ``ops/resv.py`` runs for a CPU
tensor, on every budget and every carried level -- one clip with padded
holes, ``resv_max`` 0, 7 and 8, LSF, an odd ``mean_bits``, several
tiles, a leading padded run from a size0 off the domain, holes across
chunk boundaries; chunks forced to 1, 2, 7, F and F + 1 frames; a
negative size0 or delta (the composition's own walks); batches of 1 to
32 clips with distinct levels; a valid row a clip -- with no wait on the
host and no host scan; and the wrapper refuses what the kernel does not
take, with no fall back to the host.

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


def valid_flags(kind, rng, F, C):
    """The frames' flags: all real, a padded tail, random holes, a
    leading padded run over several chunks, every frame padded, or holes
    of 1-3 frames across chunk boundaries (chunks of C frames)."""
    if kind == "all":
        return np.ones(F, bool)
    if kind == "tail":
        return np.arange(F) < F - 23
    if kind == "lead":
        return np.arange(F) >= min(F, 3 * C + C // 2 + 1)
    if kind == "none":
        return np.zeros(F, bool)
    if kind == "straddle":
        v = rng.rand(F) < 0.9
        for edge in range(C, F, C):
            lo = edge - rng.randint(0, 3)
            v[max(lo, 0):edge + rng.randint(1, 3)] = False
        return v
    return rng.rand(F) < 0.8


#: seed, frames, nch, mode_gr, mean_bits, resv_max, delta, size0, valid:
#: then a leading padded run from a size0 off the domain (not a multiple
#: of 8, above resv_max; LSF; one frame; every frame padded), holes
#: across the chunk boundaries, resv_max 7 and 8
ONE_CLIP = [
    (0, 200, 2, 2, 3080, 4088, 28, 0, "all"),
    (1, 150, 1, 2, 1460, 4088, 28, 512, "tail"),
    (2, 128, 2, 2, 3081, 4088, 12, 1024, "tail"),
    (3, 100, 2, 2, 3080, 4088, 0, 200, "holes"),
    (4, 60, 2, 2, 3080, 0, 28, 0, "tail"),
    (5, 1024, 2, 2, 3344, 4088, 28, 2000, "holes"),
    (6, 2500, 1, 1, 1080, 2040, 28, 96, "holes"),
    (7, 300, 2, 1, 1331, 2040, 28, 8, "tail"),
    (8, 300, 2, 2, 3080, 4088, 28, 203, "lead"),
    (9, 300, 2, 2, 3344, 4088, 28, 5000, "lead"),
    (10, 400, 1, 1, 1080, 2040, 28, 203, "lead"),
    (11, 1, 2, 2, 3080, 4088, 28, 203, "lead"),
    (12, 100, 2, 2, 3080, 4088, 28, 5000, "none"),
    (13, 500, 2, 2, 3344, 4088, 28, 96, "straddle"),
    (14, 200, 2, 2, 3080, 7, 28, 0, "holes"),
    (15, 200, 2, 2, 3081, 8, 28, 8, "straddle"),
]


def host_scan(pe, demand, size0, args, vf):
    """The plain version on one clip's host arrays."""
    return resv.scan_budgets(torch.as_tensor(pe), torch.as_tensor(demand),
                             int(size0), *args,
                             valid=torch.as_tensor(vf))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,F,nch,mode_gr,mean_bits,resv_max,delta,"
                         "size0,valid", ONE_CLIP,
                         ids=[f"case{c[0]}-{c[-1]}" for c in ONE_CLIP])
def test_k4_equals_the_host_scan(card, seed, F, nch, mode_gr, mean_bits,
                                 resv_max, delta, size0, valid):
    pe, demand = scan_inputs(seed, 1, F, mode_gr * nch)
    rng = np.random.RandomState(seed + 100)
    vf = valid_flags(valid, rng, F,
                     resv.chunk_frames(1, F, mode_gr * nch, resv_max))
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


#: seed of ONE_CLIP, then the chunk: 1, 2, 7, F and F + 1 frames
CHUNKED = [(c, chunk) for c in (0, 3, 5, 6, 8, 12, 13, 14)
           for chunk in (1, 2, 7, "F", "F+1")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,chunk", CHUNKED,
                         ids=[f"case{c}-C{k}" for c, k in CHUNKED])
def test_k4_at_forced_chunks(card, case, chunk):
    """Every chunk the kernels take gives the host scan's budgets and
    level (``_launch``'s test argument forces it); the holes of
    "straddle" cross the forced chunk's boundaries.  A chunk whose maps
    do not fit the walk block's shared memory is refused, with no scan
    on the host."""
    seed, F, nch, mode_gr, mean_bits, resv_max, delta, size0, valid = \
        ONE_CLIP[case]
    C = {"F": F, "F+1": F + 1}.get(chunk, chunk)
    pe, demand = scan_inputs(seed, 1, F, mode_gr * nch)
    vf = valid_flags(valid, np.random.RandomState(seed + 100), F, C)
    args = (mean_bits, resv_max, mode_gr, nch, delta)
    want_b, want_s = host_scan(pe[0], demand[0], size0, args, vf)
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, vf)]
    size_d = torch.full((1,), size0, dtype=torch.int32, device=card)
    resv.build()
    K = max(1, -(-F // C))
    if K > resv.MAX_CHUNKS or \
            2 * resv.map_words(F, C, resv_max) > resv.MAP_SMEM_BYTES:
        h0 = resv.host_scans
        with pytest.raises(RuntimeError):
            resv._launch(*ins, size_d, *args, _chunk=C)
        assert resv.host_scans == h0
        return
    with no_wait():
        got_b, got_s = resv._launch(*ins, size_d, *args, _chunk=C)
    assert torch.equal(got_b[0].cpu(), want_b)
    assert int(got_s[0]) == int(want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("size0,delta,chunk", [
    (-100000, 28, None), (-100000, 28, 3), (96, -40, None), (96, -40, 1)],
    ids=["size0-neg", "size0-neg-C3", "delta-neg", "delta-neg-C1"])
def test_k4_off_the_domain(card, size0, delta, chunk):
    """A negative size0 or delta takes the level off the domain (no path
    passes either): the composing thread walks those chunks itself, and
    K4 still == the host scan."""
    F = 120
    pe, demand = scan_inputs(41, 1, F, 4)
    vf = np.random.RandomState(41).rand(F) < 0.85
    args = (3080, 4088, 2, 2, delta)
    want_b, want_s = host_scan(pe[0], demand[0], size0, args, vf)
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, vf)]
    size_d = torch.full((1,), size0, dtype=torch.int32, device=card)
    resv.build()
    with no_wait():
        got_b, got_s = resv._launch(*ins, size_d, *args, _chunk=chunk)
    assert torch.equal(got_b[0].cpu(), want_b)
    assert int(got_s[0]) == int(want_s)


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
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, valid,
                                                      size0)]
    resv.build()
    with no_wait():
        got_b, got_s = resv._launch(*ins, *args)
    for b in range(B):
        want_b, want_s = resv.scan_budgets(
            torch.as_tensor(pe[b]), torch.as_tensor(demand[b]),
            int(size0[b]), *args, valid=torch.as_tensor(valid[b]))
        assert torch.equal(got_b[b].cpu(), want_b), b
        assert int(got_s[b]) == int(want_s), b


@pytest.mark.cuda
@pytest.mark.parametrize("nch,mode_gr,mean_bits,resv_max", [
    (2, 2, 3344, 4088), (1, 1, 1080, 2040)], ids=["mpeg1", "lsf"])
def test_k4_with_a_valid_row_a_clip_off_the_domain(card, nch, mode_gr,
                                                   mean_bits, resv_max):
    """Four clips, each its own leading padded run or holes across the
    chunk boundaries, levels off the domain among them: MPEG-1 (513
    states a map) and LSF (257)."""
    B, F = 4, 240
    R = nch * mode_gr
    pe, demand = scan_inputs(31, B, F, R)
    rng = np.random.RandomState(32)
    C = resv.chunk_frames(B, F, R, resv_max)
    valid = np.stack([valid_flags(k, rng, F, C) for k in
                      ("lead", "straddle", "lead", "holes")])
    size0 = np.array([203, 0, 5000, 96], np.int32)
    args = (mean_bits, resv_max, mode_gr, nch, 28)
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, valid,
                                                      size0)]
    resv.build()
    with no_wait():
        got_b, got_s = resv._launch(*ins, *args)
    for b in range(B):
        want_b, want_s = host_scan(pe[b], demand[b], size0[b], args,
                                   valid[b])
        assert torch.equal(got_b[b].cpu(), want_b), b
        assert int(got_s[b]) == int(want_s), b


@pytest.mark.cuda
def test_k4_captures_in_a_cuda_graph(card):
    """K4's call (its workspace from the caching allocator, the walk's
    shared-memory attribute, both kernels) captures in a CUDA graph, and
    each replay == the host scan on the inputs of the moment."""
    B, F = 2, 1024
    pe, demand = scan_inputs(61, B, F, 4)
    size0 = np.array([0, 2000], np.int32)
    args = (3344, 4088, 2, 2, 28)
    ins = [torch.as_tensor(a, device=card) for a in (pe, demand, size0)]
    resv.build()
    resv._launch(ins[0], ins[1], None, ins[2], *args)   # the attribute set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    k0 = resv.launches
    with torch.cuda.graph(graph):
        got_b, got_s = resv._launch(ins[0], ins[1], None, ins[2], *args)
    assert resv.launches - k0 == 1
    for seed in (62, 63):
        pe2, demand2 = scan_inputs(seed, B, F, 4)
        ins[0].copy_(torch.as_tensor(pe2))
        ins[1].copy_(torch.as_tensor(demand2))
        graph.replay()
        want_b, want_s = resv.scan_budgets_batched(
            torch.as_tensor(pe2), torch.as_tensor(demand2),
            torch.as_tensor(size0), *args)
        assert torch.equal(got_b.cpu(), want_b)
        assert torch.equal(got_s.cpu(), want_s)


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
